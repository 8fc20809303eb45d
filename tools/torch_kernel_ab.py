"""Shared parts of the kernel A/B tools (``tools/torch_*_ab.py``): each runs
this tree's version of one ``shapley_vit_tpu_torch/csrc`` source against
other versions of it on one NVIDIA GPU, through their C entries.

This module builds the other versions, binds their entries, orders the runs
(this, the others, the others again, this; a yardstick first and last) and
measures one run against the plain version's output, as ``chip_smoke.py``
reports its kernels. Each tool keeps only its inputs and how it calls its
entry.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo's root, above)


def print_card() -> None:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


def libraries(stem: str, fns: dict, sources=(), variants=None) -> dict:
    """{"this": this tree's ``csrc/<stem>.cu`` library, basename: the
    library of each other source, name: this tree's source built with each
    variant's extra nvcc flags ({name: flags})}, the others built in
    parallel with the port's nvcc flags and this tree's headers."""
    from shapley_vit_tpu_torch.ops import _build

    libs = {"this": _build.load(stem, fns)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = [(os.path.basename(src), src, []) for src in sources]
    builds += [(name, str(_build.CSRC / f"{stem}.cu"), flags) for name, flags in (variants or {}).items()]
    jobs = []
    for i, (name, src, flags) in enumerate(builds):
        out = _build.BUILD_DIR / f"lib{stem}-other{i}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, f"-I{_build.CSRC}", "-o", str(out), src]
        jobs.append((name, out, subprocess.Popen(cmd)))
    for name, out, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {name}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def entry(lib, name: str, argtypes):
    """``lib``'s C entry ``name``, bound to ``argtypes``, returning an int."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def order(names, yardstick=None) -> list:
    """this, the others, the others again, this; the yardstick first and
    last."""
    others = [n for n in names if n != "this"]
    ends = [yardstick] if yardstick else []
    return [*ends, "this", *others, *others, "this", *ends]


def measure(run, want, calls: int, reps: int, layout=None) -> dict:
    """One run against the plain version's output ``want``: the largest
    difference and the share of outputs that differ (``layout`` brings a
    yardstick's output to ``want``'s layout first, untimed); the time of one
    call per event pair (``ms``: ``chip_smoke.cuda_ms`` over ``reps``), the
    time of one call among ``calls`` back to back with the host's time to
    launch one (``chip_smoke.back_to_back``), and the device time of one
    call among ``calls`` back to back, the kernels alone
    (``chip_smoke.device_ms``)."""
    import torch

    got = run() if layout is None else layout(run())
    torch.cuda.synchronize()
    row = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "share_differing": (got != want).float().mean().item()}
    del got
    ms_b2b, host_us = chip_smoke.back_to_back(run, calls)
    return {**row, "ms": chip_smoke.cuda_ms(run, reps), "ms_back_to_back": ms_b2b,
            "host_us": host_us, "device_ms": chip_smoke.device_ms(run, calls)[0]}
