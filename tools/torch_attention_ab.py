#!/usr/bin/env python3
"""Compare this tree's bf16 attention kernel with another version of
``shapley_vit_tpu_torch/csrc/attention.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/attention.cu > exp/other_attention.cu
    python3 tools/torch_attention_ab.py exp/other_attention.cu

The other source is compiled with the port's nvcc flags. Both are called
through their ``svt_attention_bhnd_bf16`` entries (the C signature is the
same in both) with the packed layout's strides, as ``fused_attention_packed``
calls it. Inputs: the bf16 inputs of ``chip_smoke.py``'s ``kernels`` phase
(``chip_smoke.kernel_inputs``: ``smoke_packed`` [896, 197, 768] and
``smoke_bhnd``, the [64, 12, 197, 64] split-head views), and those of
``tests/test_torch_kernels.py::test_attention_bf16_error_at_the_round_shape``
(``round_shape_inputs``; ``test_packed``). For each kernel and input, one
JSON line: the largest difference from the plain version's bf16 output
(``max_abs_err``, as ``chip_smoke.py`` reports it), the share of outputs
whose bf16 value differs from the plain version's, the same two against the
float64 result (``exact_*``: bf16 rounding of the exact value), and the
device time of one call among 20 back to back with the host's time to
launch one (``ms``, ``host_us``: ``chip_smoke.back_to_back``), kernels in
the order this, other, other, this.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo's root, above)


def entries(src: str):
    """This tree's ``svt_attention_bhnd_bf16`` and the other source's."""
    from shapley_vit_tpu_torch.ops import _build
    from shapley_vit_tpu_torch.ops import attention as att

    this = _build.load("attention", att._FNS).svt_attention_bhnd_bf16
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libattention-other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", str(out), src],
                   check=True)
    other = ctypes.CDLL(str(out)).svt_attention_bhnd_bf16
    other.argtypes = att._FNS["svt_attention_bhnd_bf16"]
    other.restype = ctypes.c_int
    return this, other


def inputs():
    """(name, q, k, v) packed [B, N, 768] bf16: chip_smoke.py's and the card
    test's."""
    import torch

    path = os.path.join(ROOT, "tests", "test_torch_kernels.py")
    spec = importlib.util.spec_from_file_location("test_torch_kernels", path)
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    t = chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    smoke = [("smoke_packed", t["q"], t["k"], t["v"]), ("smoke_bhnd", t["tq"], t["tk"], t["tv"])]
    del t
    return smoke + [("test_packed", *tests.round_shape_inputs())]


def main() -> int:
    import torch

    from shapley_vit_tpu_torch.ops import attention as att

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    this, other = entries(sys.argv[1])
    H, N = 12, 197
    stream = torch.cuda.current_stream().cuda_stream

    for name, q, k, v in inputs():
        B = q.shape[0]
        views = [t.view(B, N, H, 64).transpose(1, 2) for t in (q, k, v)]
        want = att.fused_attention_packed_plain(q, k, v, heads=H)
        qd, kd, vd = (t.double() for t in views)
        exact = (torch.softmax(qd @ kd.transpose(-1, -2) * 0.125, -1) @ vd)
        exact = exact.transpose(1, 2).reshape(B, N, H * 64)
        del qd, kd, vd
        exact_bf16 = exact.to(torch.bfloat16)

        def runner(fn, which):
            def run():
                out = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
                         N * H * 64, 64, H * 64, 0.125, stream)
                if err:
                    raise RuntimeError(f"{which} kernel: cudaError {err}")
                return out
            return run

        kernels = {"this": runner(this, "this"), "other": runner(other, "other")}
        for which in ("this", "other", "other", "this"):
            got = kernels[which]()
            torch.cuda.synchronize()
            ms, host_us = chip_smoke.back_to_back(kernels[which], 20)
            print(json.dumps({
                "inputs": name, "kernel": which, "shape": list(q.shape),
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "share_differing": (got != want).float().mean().item(),
                "exact_max_abs_err": (got.double() - exact).abs().max().item(),
                "exact_share_differing": (got != exact_bf16).float().mean().item(),
                "ms": ms, "host_us": host_us,
            }), flush=True)
        del exact, exact_bf16, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
