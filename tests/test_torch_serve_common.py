"""Shared set-up of the port's service tests (no tests of its own):
a micro-ViT ``Config`` on the synthetic OCT validation set, and epoch drops
of LoRA checkpoints made from a seed with numpy."""

import os

import numpy as np

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.driver import start as tstart
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.models.convert import tree_to_numpy
from shapley_vit_tpu_torch.ops import tree_math as tm


def service_cfg(tmp_path, cls=Config, local=None):
    """The JAX service tests' configuration (tests/test_serve.py), in either
    package's ``Config``; ``local`` shares another test's drops."""
    cfg = cls()
    cfg.model.model_type = "ViT-micro"
    cfg.data.eval_batch_size = 32
    cfg.obs.exp_dir = str(tmp_path / "exp")
    cfg.paths.validation_dataset = str(tmp_path / "none")
    cfg.data.synthetic_scale = 0.02
    cfg.paths.local_model_path = str(local or tmp_path / "local")
    cfg.paths.global_model_path = str(tmp_path / "global")
    cfg.obs.render_plots = False
    return cfg


def port_model(cfg):
    """The port's micro model on the CPU: (spec, base, init_lora)."""
    return tstart.build_model(cfg, device="cpu")


def write_epoch(cfg, spec, overlay, epoch, clients=3, scale=0.05, save=None):
    """One epoch's drops: ``overlay`` plus seeded noise per client, as torch
    ``.pth.tar`` checkpoints under ``cfg.paths.local_model_path``."""
    save = save or ingestion.save_lora_checkpoint
    host = tree_to_numpy(overlay)
    paths = []
    for i in range(clients):
        rng = np.random.default_rng(epoch * 10 + i)
        drop = tm.tree_map(lambda a: a + (scale * rng.normal(size=a.shape)).astype(np.float32), host)
        p = os.path.join(cfg.paths.local_model_path, f"client_{i + 1}_model",
                         f"ViT_epoch_{epoch}.pth.tar")
        save(p, drop, spec)
        paths.append(p)
    return paths


def corrupt_epoch(cfg, epoch, clients=3, payload=b"not a checkpoint"):
    for i in range(clients):
        p = os.path.join(cfg.paths.local_model_path, f"client_{i + 1}_model",
                         f"ViT_epoch_{epoch}.pth.tar")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(payload)
