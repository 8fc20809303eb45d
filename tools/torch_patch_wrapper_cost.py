#!/usr/bin/env python3
"""The host's time per ``patch_embed`` call of this tree's wrapper against
another version of ``shapley_vit_tpu_torch/ops/patch_embed.py``, in one
process on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/ops/patch_embed.py > exp/other_patch_embed.py
    python3 tools/torch_patch_wrapper_cost.py exp/other_patch_embed.py

Both modules launch the same kernel through this tree's ``ops/_build``.
Inputs: bf16 images of 224 px, ViT-B's [768, 768] kernel, at the round's
128 images and the training step's 64. Two modes, as the main paths call
the wrapper: under ``torch.inference_mode`` (round, service, evaluation)
and with autograd on but no input requiring a gradient (the training
step, whose base weights are frozen). For each: the host's µs per call
over 200 calls launched back to back (the clock stopped before waiting
for the card), median of 5 runs, ordered this, other, other, this; and
the device's ms per call (CUDA events) over the same calls. One JSON line
per (wrapper, batch, mode, turn), then a summary line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_call(fn, calls: int = 200, runs: int = 5) -> tuple:
    """(host µs, device ms) of one call among ``calls`` back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        host.append(1e6 * (t1 - t0) / calls)
        dev.append(a.elapsed_time(b) / calls)
    return statistics.median(host), statistics.median(dev)


def main() -> int:
    import torch

    from shapley_vit_tpu_torch.ops import _build

    other_path = sys.argv[1]
    this = load(os.path.join(ROOT, "shapley_vit_tpu_torch", "ops", "patch_embed.py"), "this_pe")
    other = load(other_path, "other_pe")
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    modes = {"inference_mode": torch.inference_mode,
             "autograd_no_input_grad": torch.enable_grad}
    summary = {}
    for batch in (128, 64):
        img = torch.rand((batch, 224, 224, 3), generator=gen, device="cuda").to(torch.bfloat16)
        pw = (torch.randn((768, 768), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        pb = (torch.randn((768,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        for mode, ctx in modes.items():
            for turn, (label, mod) in enumerate((("this", this), ("other", other),
                                                 ("other", other), ("this", this))):
                with ctx():
                    host_us, dev_ms = per_call(lambda: mod.patch_embed(img, pw, pb, 16))
                row = {"wrapper": label, "batch": batch, "mode": mode, "turn": turn,
                       "host_us": host_us, "device_ms": dev_ms}
                print(json.dumps(row), flush=True)
                summary.setdefault(f"{mode}/{batch}", {}).setdefault(label, []).append(host_us)
    print(json.dumps({"host_us": summary, "other": other_path,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
