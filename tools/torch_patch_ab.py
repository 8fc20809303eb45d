#!/usr/bin/env python3
"""Compare this tree's bf16 patch-embedding kernel with other versions of
``shapley_vit_tpu_torch/csrc/patch_embed.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/patch_embed.cu > exp/other_patch_embed.cu
    python3 tools/torch_patch_ab.py exp/other_patch_embed.cu [more.cu ...]

Each other source is compiled with the port's nvcc flags (its headers from
this tree's ``csrc/``). All are called through their ``svt_patch_embed_bf16``
entries (the C signature has not changed) on the bf16 inputs of
``chip_smoke.py``'s ``kernels`` phase (``chip_smoke.kernel_inputs``, seed 0:
[128, 224, 224, 3] images, a [768, 768] kernel, 16-px patches). For each
kernel one JSON line: the largest difference from the plain version's bf16
output and the share of outputs whose bf16 value differs from it (as
``chip_smoke.py`` reports them), the time of one call per event pair
(``ms``: ``chip_smoke.cuda_ms``) and the device time of one call among 100
back to back with the host's time to launch one (``ms_back_to_back``,
``host_us``: ``chip_smoke.back_to_back``). Kernels run in the order this,
the others, the others again, this; ``F.conv2d`` (cuDNN) runs first and last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo's root, above)


def entries(sources):
    """{name: svt_patch_embed_bf16} of this tree and of each other source,
    built in parallel."""
    from shapley_vit_tpu_torch.ops import _build
    from shapley_vit_tpu_torch.ops import patch_embed as pe

    fns = {"this": _build.load("patch_embed", pe._FNS).svt_patch_embed_bf16}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, src in enumerate(sources):
        out = _build.BUILD_DIR / f"libpatch_embed-other{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out), src]
        jobs.append((src, out, subprocess.Popen(cmd)))
    for src, out, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src}")
        fn = ctypes.CDLL(str(out)).svt_patch_embed_bf16
        fn.argtypes = pe._FNS["svt_patch_embed_bf16"]
        fn.restype = ctypes.c_int
        fns[os.path.basename(src)] = fn
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import patch_embed as pe

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fns = entries(sys.argv[1:])
    t = chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    img, w, b = t["img"], t["pw"], t["pb"]
    del t
    torch.cuda.empty_cache()
    B, H, W, C = img.shape
    P, D = chip_smoke.P, w.shape[1]
    want = pe.patch_embed_plain(img, w, b, P)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(name):
        fn = fns[name]

        def run():
            out = torch.empty((B, (H // P) * (W // P), D), dtype=img.dtype, device="cuda")
            err = fn(img.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W, C, P, D,
                     stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out
        return run

    conv_w = w.reshape(P, P, C, D).permute(3, 2, 0, 1).contiguous()
    nchw = img.permute(0, 3, 1, 2)
    runs = {"F.conv2d": lambda: F.conv2d(nchw, conv_w, b, stride=P)}
    runs.update({name: runner(name) for name in fns})
    others = [n for n in fns if n != "this"]
    for name in ["F.conv2d", "this", *others, *others, "this", "F.conv2d"]:
        got = runs[name]()
        if name == "F.conv2d":
            got = got.permute(0, 2, 3, 1).reshape(want.shape)
        torch.cuda.synchronize()
        ms_b2b, host_us = chip_smoke.back_to_back(runs[name], 100)
        print(json.dumps({
            "kernel": name, "shape": list(img.shape), "max_abs_err":
            (got.float() - want.float()).abs().max().item(),
            "share_differing": (got != want).float().mean().item(),
            "ms": chip_smoke.cuda_ms(runs[name], 20), "ms_back_to_back": ms_b2b,
            "host_us": host_us,
        }), flush=True)
        del got
    return 0


if __name__ == "__main__":
    sys.exit(main())
