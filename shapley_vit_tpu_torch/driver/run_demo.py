"""Zero-config end-to-end demo: ``python -m shapley_vit_tpu_torch.driver.run_demo``.

The port of ``shapley_vit_tpu/driver/run_demo.py``: one pass over the
reference's one-shot deployment shape without a ``.env``, datasets on disk
or an external FL trainer:

  1. build ViT + LoRA with a synthetic OCT-layout dataset (Dirichlet
     non-IID client shards);
  2. fine-tune each client locally (``fl/training``, through the kernels
     that have a gradient);
  3. drop their checkpoints through the atomic-rename protocol with
     ``num_local_data_train`` metadata (the FedAvg ratios);
  4. run ``driver.start.start()`` and return the per-client Shapley values.

Unlike the JAX demo it exports no global overlay (``GLOBAL_MODEL_PATH`` is
not ported yet). Runs on the card unless ``device="cpu"`` is passed, at
its defaults (micro, 16 px) or any other variant; the CLI runs ViT-B/16 at
224 px on the card.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.data.partition import partition_labeldir
from shapley_vit_tpu_torch.data.registry import get_dataset
from shapley_vit_tpu_torch.driver import start as start_mod
from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.fl import training as tr
from shapley_vit_tpu_torch.models import vit as tvit


def run_demo(
    out_dir: Optional[str] = None,
    n_clients: int = 3,
    local_steps: int = 4,
    variant: str = "micro",
    image_size: int = 16,
    seed: int = 0,
    device=None,
):
    """Run the one-shot flow; returns (all_rounds_sv, sv_sum, out_dir)."""
    device = start_mod.resolve_device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="svt_demo_")
    cfg = Config()
    cfg.model.vit_variant = variant
    cfg.model.model_type = f"ViT-{variant}"
    cfg.data.image_size = image_size
    cfg.data.eval_batch_size = 32
    cfg.data.synthetic_scale = 0.02
    cfg.obs.exp_dir = os.path.join(out_dir, "exp")
    cfg.paths.validation_dataset = ""  # synthetic OCT layout
    cfg.paths.local_model_path = os.path.join(out_dir, "local")
    cfg.shapley.num_clients = n_clients

    spec, base, init_lora = start_mod.build_model(cfg, device=device)
    spec = spec.replace(**TRAIN_SPEC)

    # non-IID client shards of the synthetic training split
    splits, info = get_dataset(
        cfg.data.dataset_type,
        data_dir=cfg.paths.validation_dataset,
        synthetic_scale=cfg.data.synthetic_scale,
    )
    train = splits["train"]
    _, mapping = partition_labeldir(
        train.labels, num_classes=info["num_classes"], n_parties=n_clients,
        beta=0.5, seed=seed + 42,
    )
    opt = tr.adam(5e-3)
    step = tr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec),
                              spec.num_classes)
    paths = []
    for cid in range(n_clients):
        idx = mapping[cid][:64]
        x = train.images[idx]
        if x.shape[1] != spec.image:
            x = start_mod.resize_images(x, spec.image, device=device)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        y = torch.as_tensor(train.labels[idx], device=device)
        lora = tr.trainable(init_lora)
        opt_state = opt.init(lora)
        gen = torch.Generator().manual_seed(seed * 100 + cid)
        for _ in range(local_steps):
            lora, opt_state, _ = step(base, lora, opt_state, x, y, gen)
        p = os.path.join(cfg.paths.local_model_path, f"client_{cid + 1}_model", "ViT_epoch_9.npz")
        ingestion.save_lora_checkpoint(p, lora, spec, num_local_data_train=len(mapping[cid]))
        paths.append(p)

    all_rounds, sv_sum = start_mod.start(cfg, checkpoint_paths=paths, device=device)
    return all_rounds, sv_sum, out_dir


def main():
    """On the card: ViT-B/16 at 224 px."""
    all_rounds, sv_sum, out_dir = run_demo(variant="base", image_size=224, device="cuda")
    print(f"demo artifacts: {out_dir}")
    print(f"per-round Shapley values: {all_rounds}")
    print(f"SV sums (efficiency axiom): {sv_sum}")


if __name__ == "__main__":
    main()
