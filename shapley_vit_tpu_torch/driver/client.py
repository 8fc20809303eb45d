"""Local FL client driver — the writer side of the shared-filesystem
protocol (the port of ``shapley_vit_tpu/driver/client.py``).

Per epoch: adopt the latest global export in ``GLOBAL_MODEL_PATH`` when
there is a new one, fine-tune the LoRA overlay on the client's shard
(label-flip fixture and DP-SGD through the reference's ``label_flip_prob`` /
``--noise-multiplier`` knobs), and drop ``ViT_epoch_{e}.npz`` (or
``.pth.tar``) with ``num_local_data_train`` metadata through the
atomic-rename protocol. The server's ``start()`` ingests these files.

The model trains through the kernels that have a gradient:
``attention_impl="pallas"`` (``fused_attention`` on ``[B, H, N, d]``) and
``mlp_impl="xla"``. Runs on the card unless ``device="cpu"`` is passed;
``python -m shapley_vit_tpu_torch.driver.client --dist-rank <id> ...`` runs
on the card.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.data.partition import partition_labeldir
from shapley_vit_tpu_torch.data.registry import get_dataset
from shapley_vit_tpu_torch.driver import start as start_mod
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.fl import training as tr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.utils.logging import get_logger
from shapley_vit_tpu_torch.utils.profiling import StepTimer

# the spec change that makes the ViT differentiable end to end
TRAIN_SPEC = dict(attention_impl="pallas", mlp_impl="xla")


def latest_global_export(global_dir: Optional[str]) -> Optional[str]:
    """Newest global-overlay checkpoint the server exported, by epoch
    number (``ViT_global_epoch_{e}.npz``; the one-shot driver's un-numbered
    ``ViT_global.npz`` is used only when no numbered export exists)."""
    if not global_dir or not os.path.isdir(global_dir):
        return None
    best, best_epoch = None, -1
    for p in glob.glob(os.path.join(global_dir, "ViT_global_epoch_*.npz")):
        m = re.search(r"ViT_global_epoch_(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = p, int(m.group(1))
    if best is None:
        plain = os.path.join(global_dir, "ViT_global.npz")
        if os.path.exists(plain):
            return plain
    return best


def client_shard(cfg: Config, client_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """The client's non-IID shard of the configured dataset's training
    split (a synthetic stand-in when the dataset is not on disk)."""
    splits, info = get_dataset(
        cfg.data.dataset_type,
        data_dir=cfg.paths.validation_dataset or cfg.data.data_dir,
        synthetic_ok=True,
        seed=cfg.shapley.seed,
        synthetic_scale=cfg.data.synthetic_scale,
    )
    train = splits["train"]
    _, mapping = partition_labeldir(
        train.labels, num_classes=info["num_classes"],
        n_parties=max(cfg.shapley.num_clients, client_id + 1),
        beta=0.5, seed=cfg.shapley.seed + 42,
    )
    idx = mapping[client_id]
    return train.images[idx], train.labels[idx]


def run_client(
    cfg: Optional[Config] = None,
    client_id: int = 0,
    epochs: int = 1,
    steps_per_epoch: int = 4,
    data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    start_epoch: int = 0,
    seed: int = 0,
    lr: Optional[float] = None,
    ckpt_format: Optional[str] = None,
    device=None,
    timer: Optional[StepTimer] = None,
) -> List[str]:
    """Train this client locally and drop per-epoch checkpoints; returns
    the written paths. ``data`` is the client's local (images, labels)
    shard; when None, :func:`client_shard` stands in.
    ``cfg.train.label_flip_prob`` poisons labels (reference
    client.py:53-59); ``cfg.train.use_dp`` with ``cfg.train.noise_multiplier
    > 0`` switches the local optimizer to DP-SGD at ``cfg.train.lr``. ``lr``
    sets the non-DP Adam rate (None keeps 5e-3). ``cfg.train.remat``
    recomputes each block's activations in the backward (``ViTSpec.remat``).

    ``ckpt_format``: ``"npz"`` (default) or ``"pth.tar"`` (the reference's
    torch format); defaults from ``$SVT_CLIENT_CKPT_FORMAT``. ``timer``, when
    given, times each step (waiting for the card) under ``"train_step"``."""
    cfg = cfg or Config.from_env()
    fmt = ckpt_format or os.environ.get("SVT_CLIENT_CKPT_FORMAT", "npz")
    if fmt not in ("npz", "pth.tar"):
        raise ValueError(
            f"ckpt_format {fmt!r} not in ('npz', 'pth.tar') "
            "(set via argument or $SVT_CLIENT_CKPT_FORMAT)"
        )
    device = start_mod.resolve_device(device)
    logger = get_logger()
    spec, base, init_lora = start_mod.build_model(cfg, device=device)
    spec = spec.replace(remat=cfg.train.remat, **TRAIN_SPEC)

    def fwd(b, lo, x):
        return tvit.vit_forward(b, lo, x, spec)

    images, labels = client_shard(cfg, client_id) if data is None else data
    n_local = int(len(labels))
    if n_local == 0:
        raise ValueError(f"client {client_id} has an empty local shard")
    if steps_per_epoch < 1:
        raise ValueError("steps_per_epoch must be >= 1")
    if images.shape[1] != spec.image:
        images = start_mod.resize_images(images.astype(np.float32), spec.image, device=device)
    images = torch.as_tensor(np.asarray(images, np.float32), device=device)
    labels = torch.as_tensor(np.asarray(labels), device=device)
    batch = min(cfg.train.train_batch * 8, n_local) or 1

    # DP-SGD is an explicit opt-in (cfg.train.use_dp): the reference's
    # --noise-multiplier DEFAULT is 0.5, so a >0 multiplier alone must not
    # switch optimizers. Label flipping applies in both modes (the DP step
    # has no built-in flip; it is applied below).
    dp = cfg.train.use_dp and cfg.train.noise_multiplier > 0
    if dp:
        step, opt = tr.make_dp_train_step(
            fwd, learning_rate=cfg.train.lr, l2_norm_clip=1.0,
            noise_multiplier=cfg.train.noise_multiplier,
            seed=seed + client_id,
        )
    else:
        opt = tr.adam(5e-3 if lr is None else lr)
        step = tr.make_train_step(fwd, spec.num_classes,
                                  label_flip_prob=cfg.train.label_flip_prob)

    root = cfg.paths.local_model_path or os.path.join(os.getcwd(), "local_training")
    rng = np.random.default_rng(seed * 1000 + client_id)
    gen = torch.Generator().manual_seed(seed * 1000 + client_id)
    lora = tr.trainable(init_lora)
    state = opt.init(lora)
    last_global: Optional[str] = None
    written: List[str] = []
    for epoch in range(start_epoch, start_epoch + epochs):
        # FedAvg round-trip: adopt the server's latest exported global.
        # A new global resets the optimizer state (fresh moments for fresh
        # weights); otherwise training continues where the previous epoch
        # left off
        g = latest_global_export(cfg.paths.global_model_path)
        if g is not None and g != last_global:
            try:
                lora = tr.trainable(tree_from_numpy(ingestion.load_client_lora(g, spec), device))
                state = opt.init(lora)
                if dp:
                    # a fresh noise stream for every adoption: init reseeds
                    # it, and replayed noise cancels between checkpoints
                    seed_next = int(torch.randint(0, 2**62, (1,), generator=gen))
                    state = tr.refresh_dp_noise_key(state, seed_next)
                last_global = g
                logger.info(f"client {client_id}: synced from {os.path.basename(g)}")
            except Exception as e:
                logger.info(f"client {client_id}: ignoring unreadable global {g}: {e}")
        for _ in range(steps_per_epoch):
            take = torch.as_tensor(rng.choice(n_local, size=batch, replace=n_local < batch),
                                   device=device)
            x, y = images[take], labels[take]
            with timer.span("train_step") if timer is not None else contextlib.nullcontext():
                if dp:
                    y = tr.label_flip(gen, y, spec.num_classes, cfg.train.label_flip_prob)
                    lora, state, loss = step(base, lora, state, x, y)
                else:
                    lora, state, loss = step(base, lora, state, x, y, gen)
                if timer is not None:
                    float(loss)  # wait for the card
        p = os.path.join(root, f"client_{client_id + 1}_model", f"ViT_epoch_{epoch}.{fmt}")
        ingestion.save_lora_checkpoint(p, lora, spec, num_local_data_train=n_local)
        written.append(p)
        logger.info(f"client {client_id}: epoch {epoch} done (loss {float(loss):.4f}) -> {p}")
    return written


def main(argv=None):
    """Console entry: the reference CLI flags + .env path contract;
    ``--dist-rank`` selects the client id (the reference's party rank). Runs
    on the card."""
    args = sys.argv[1:] if argv is None else argv
    cfg = Config.from_args(args)
    cfg.paths = Config.from_env().paths
    run_client(
        cfg,
        client_id=cfg.dist.dist_rank,
        epochs=max(1, cfg.train.epoch_end - cfg.train.epoch_st),
        start_epoch=cfg.train.epoch_st,
        # honour an explicit -lr; the bare default (3e-1, reference parity)
        # would diverge LoRA-Adam, and the reference itself ignores -lr for
        # its in-repo Adam (start.py:62-66)
        lr=cfg.train.lr if "-lr" in args else None,
        device="cuda",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
