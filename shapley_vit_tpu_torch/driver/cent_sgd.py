"""Centralized-SGD baseline: the port of ``shapley_vit_tpu/driver/cent_sgd.py``.

Reference: ``federated_learning/cent_sgd.py`` (own argparse at 14-36,
exp-sequence bookkeeping in ``exp_seq.txt`` at 38-73, per-experiment seeding,
ResNet18/50-or-ConvNet training with SGD+momentum 0.9 + weight decay,
per-epoch test metrics via ``get_metrics``, best-accuracy checkpointing at
137-148, multi-run mean/std summary + loss/acc/auc curve PNGs +
learning-curve dump at 157-204).

The port trains a ``models.zoo`` module in train mode (BatchNorm on batch
statistics, its running statistics updated as flax's are) with
``torch.optim.SGD(momentum=0.9, weight_decay=...)``, which is the JAX
package's ``optax.chain(add_decayed_weights, sgd(momentum=0.9))``: the decay
is added to the gradient before the momentum trace. The best-accuracy
checkpoint goes through ``fl.ingestion.atomic_save_npz`` with the JAX
checkpoint's keys (``params.Conv_0.kernel``, ``batch_stats.BatchNorm_0.mean``,
flax layouts). Runs on the card unless ``--device cpu`` is passed.

Run: ``python -m shapley_vit_tpu_torch.driver.cent_sgd --dataset cifar10 --model ConvNet``
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F


def argparser():
    """Flag surface parity with cent_sgd.py:14-36, plus ``--device``."""
    parser = argparse.ArgumentParser(description="centralized sgd baseline")
    parser.add_argument("--dataset", type=str, default="cifar10")
    parser.add_argument("--model", type=str, default="ResNet18")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_exp", type=int, default=3)
    parser.add_argument("--n_workers", type=int, default=0)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--batch_train", type=int, default=64)
    parser.add_argument("--epoch_train", type=int, default=50)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--save_root", type=str, default="result")
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--save_curves", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def set_path(args):
    """Experiment sequence-number bookkeeping (cent_sgd.py:38-73)."""
    os.makedirs(args.save_root, exist_ok=True)
    save_tag = (
        f"centralized_sgd-{args.dataset}-{args.model}-ep{args.epoch_train}-lr{args.lr}"
    )
    exp_seq_path = os.path.join(args.save_root, "exp_seq.txt")
    if not os.path.exists(exp_seq_path):
        exp_seq = 0
    else:
        with open(exp_seq_path) as f:
            exp_seq = int(f.read()) + 1
    with open(exp_seq_path, "w") as f:
        f.write(str(exp_seq))
    args.exp_seq = str(exp_seq)
    args.save_path = os.path.join(args.save_root, f"exp_{exp_seq}_{save_tag}")
    os.makedirs(args.save_path, exist_ok=True)
    args.config_path = os.path.join(args.save_path, "config.json")
    args.logger_path = os.path.join(args.save_path, "exp_log.log")
    return args


def make_optimizer(module: torch.nn.Module, lr: float, weight_decay: float) -> torch.optim.SGD:
    """``optax.chain(add_decayed_weights(weight_decay), sgd(lr, momentum=0.9))``
    over every parameter (cent_sgd.py:88-91)."""
    return torch.optim.SGD(module.parameters(), lr=lr, momentum=0.9, weight_decay=weight_decay)


def make_train_step(module: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """``step(x, y) -> loss``: the module in train mode (BatchNorm's running
    statistics move), mean cross-entropy on float32 logits, backward, one
    update. The loss is returned on the device, unread."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        module.train()
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(module(x).float(), y.long())
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _flatten(prefix: str, tree: dict, flat: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{k}.", v, flat)
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def train_one_experiment(args, exp_idx: int, logger):
    """One seeded run (cent_sgd.py:88-150): train, per-epoch metrics, best-acc
    checkpoint. Returns (best_acc, best_auc, curves dict, seconds in the
    training steps of each epoch)."""
    from shapley_vit_tpu_torch.data.registry import get_dataset
    from shapley_vit_tpu_torch.fl.ingestion import atomic_save_npz
    from shapley_vit_tpu_torch.models import zoo
    from shapley_vit_tpu_torch.models.convert import state_dict_to_flax_zoo
    from shapley_vit_tpu_torch.utils.eval_metrics import collect_logits, get_metrics

    device = torch.device(args.device)
    splits, info = get_dataset(args.dataset, data_dir=args.data_dir, synthetic_ok=True)
    train_ds, test_ds = splits["train"], splits["test"]

    im_size = train_ds.images.shape[1:3]
    channel = train_ds.images.shape[-1]
    module, _, _ = zoo.get_network(args.model, channel, info["num_classes"], im_size,
                                   seed=args.seed + exp_idx, device=device)
    optimizer = make_optimizer(module, args.lr, args.weight_decay)
    step = make_train_step(module, optimizer)

    images = torch.as_tensor(np.asarray(train_ds.images, np.float32), device=device)
    labels = torch.as_tensor(np.asarray(train_ds.labels).astype(np.int64), device=device)
    rng = np.random.default_rng(args.seed + exp_idx)
    n = len(train_ds)
    curves = {"loss": [], "acc": [], "auc": []}
    best_acc, best_auc, epoch_s = 0.0, 0.0, []
    params = dict(module.named_parameters())

    def eval_forward(_params, x):
        module.eval()
        return module(x)

    for epoch in range(args.epoch_train):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        t0 = time.perf_counter()
        ep_loss, batches = torch.zeros((), device=device), 0
        for i in range(0, n, args.batch_train):
            idx = perm[i : i + args.batch_train]
            ep_loss += step(images[idx], labels[idx])
            batches += 1
        ep_loss = float(ep_loss)  # waits for the card
        epoch_s.append(time.perf_counter() - t0)
        logits, test_labels = collect_logits(eval_forward, params, test_ds, args.batch_train)
        loss, acc, auc, bal = get_metrics(logits, test_labels)
        curves["loss"].append(ep_loss / batches)
        curves["acc"].append(acc)
        curves["auc"].append(auc)
        logger.info(
            f"exp {exp_idx} epoch {epoch}: train_loss={ep_loss / batches:.4f} "
            f"test_acc={acc:.4f} auc={auc:.4f} bal_acc={bal:.4f}"
        )
        if acc > best_acc:
            best_acc, best_auc = acc, auc
            # best-acc checkpoint (cent_sgd.py:142-147), the JAX keys
            flat = _flatten("", state_dict_to_flax_zoo(module.state_dict()), {})
            atomic_save_npz(
                os.path.join(args.save_path, f"checkpoint_exp{exp_idx}.npz"),
                {**flat, "__epoch__": np.asarray(epoch), "__loss__": np.asarray(curves["loss"][-1])},
            )
    return best_acc, best_auc, curves, epoch_s


def main(args=None, argv=None):
    from shapley_vit_tpu_torch.utils.logging import get_logger

    if args is None:
        args = set_path(argparser().parse_args(argv))
    logger = get_logger("cent_sgd", args.logger_path)
    with open(args.config_path, "w") as f:
        json.dump(vars(args), f, indent=4)

    t0 = time.time()
    accs, aucs, all_curves, epoch_s = [], [], [], []
    for exp_idx in range(args.num_exp):
        acc, auc, curves, seconds = train_one_experiment(args, exp_idx, logger)
        accs.append(acc)
        aucs.append(auc)
        all_curves.append(curves)
        epoch_s.append(seconds)

    # multi-run mean/std summary (cent_sgd.py:157-176), with the seconds
    # spent in training steps, in all and by experiment and epoch (the
    # first epoch carries cuDNN's warm-up)
    summary = {
        "acc_mean": float(np.mean(accs)), "acc_std": float(np.std(accs)),
        "auc_mean": float(np.mean(aucs)), "auc_std": float(np.std(aucs)),
        "wall_clock_s": time.time() - t0, "train_s": float(np.sum(epoch_s)),
        "epoch_train_s": epoch_s,
    }
    logger.info(f"summary over {args.num_exp} runs: {summary}")
    with open(os.path.join(args.save_path, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)

    # learning-curve dump (cent_sgd.py:197-204) + optional PNGs
    np.savez(
        os.path.join(args.save_path, "curves.npz"),
        **{
            f"{k}_{i}": np.asarray(c[k])
            for i, c in enumerate(all_curves)
            for k in ("loss", "acc", "auc")
        },
    )
    if args.save_curves:
        from shapley_vit_tpu_torch.utils.plots import plot_series_mul

        for metric in ("loss", "acc", "auc"):
            plot_series_mul(
                [c[metric] for c in all_curves],
                title=f"{args.model} {metric}",
                y_min=None, y_max=None,
                save=True,
                save_path=os.path.join(args.save_path, f"{metric}.png"),
            )
    return summary


def cli(argv=None) -> int:
    """Console entry: ``main()`` returns the summary dict for library
    callers; the console wrapper exits with the return, so the CLI needs an
    int."""
    main(argv=argv)
    return 0


if __name__ == "__main__":
    main()
