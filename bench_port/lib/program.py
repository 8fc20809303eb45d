"""What the benchmark takes from the program (``shapley_vit_tpu_torch``):
its model spec and config built from a configuration file, and its launch
counters. Imported only inside a run, never by the harness's frame."""

from __future__ import annotations

import logging
from collections import Counter
from typing import Dict


def spec(config: dict, **overrides):
    """The program's ``ViTSpec`` at the configuration's widths and numerics."""
    from shapley_vit_tpu_torch.models import vit as tvit

    kw = dict(hidden=config["hidden_size"], depth=config["num_hidden_layers"],
              heads=config["num_attention_heads"], mlp_dim=config["intermediate_size"],
              patch=config["patch_size"], image=config["image_size"],
              channels=config["num_channels"], num_classes=config["num_labels"],
              layernorm_eps=config["layer_norm_eps"], lora_r=config["lora_r"],
              lora_alpha=float(config["lora_alpha"]), dtype=config["compute_dtype"],
              gelu=config["gelu"])
    kw.update(overrides)
    return tvit.ViTSpec(**kw)


def quiet_logger() -> logging.Logger:
    """A logger that drops the estimator's per-round info lines."""
    log = logging.getLogger("bench_port.program")
    log.setLevel(logging.WARNING)
    log.propagate = False
    return log


def launch_counts() -> Dict[str, Counter]:
    """A copy of each kernel wrapper's launches by kernel."""
    from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

    return {w.__name__: Counter(w.launches_by) for w in
            (patch_embed, fused_attention_packed, fused_attention, fused_mlp_block)}


def launches_between(before: Dict[str, Counter], after: Dict[str, Counter]) -> Dict[str, dict]:
    return {w: {k: n - before[w].get(k, 0) for k, n in after[w].items() if n != before[w].get(k, 0)}
            for w in after}


def peak_memory(devices) -> int:
    import torch

    return max((int(torch.cuda.max_memory_allocated(d)) for d in devices if d.type == "cuda"),
               default=0)


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
