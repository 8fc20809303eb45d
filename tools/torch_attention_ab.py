#!/usr/bin/env python3
"""Compare this tree's bf16 attention kernel with other versions of
``shapley_vit_tpu_torch/csrc/attention.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/attention.cu > exp/other_attention.cu
    python3 tools/torch_attention_ab.py exp/other_attention.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py``, through
its ``svt_attention_bhnd_bf16`` entry (the C signature is the same in all)
with the packed layout's strides, as ``fused_attention_packed`` calls it.
Inputs: the bf16 inputs of ``chip_smoke.py``'s ``kernels`` phase
(``chip_smoke.kernel_inputs``: ``smoke_packed`` [896, 197, 768] and
``smoke_bhnd``, the [64, 12, 197, 64] split-head views), and those of
``tests/test_torch_kernels.py::test_attention_bf16_error_at_the_round_shape``
(``round_shape_inputs``; ``test_packed``). For each kernel and input, one
JSON line (``torch_kernel_ab.measure``: error and share differing from the
plain version's bf16 output, ms per call, ms among 20 back to back, host
µs) and the same two errors against the float64 result (``exact_*``: bf16
rounding of the exact value).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch_kernel_ab as ab


def inputs():
    """(name, q, k, v) packed [B, N, 768] bf16: chip_smoke.py's and the card
    test's."""
    import torch

    path = os.path.join(ab.ROOT, "tests", "test_torch_kernels.py")
    spec = importlib.util.spec_from_file_location("test_torch_kernels", path)
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    t = ab.chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    smoke = [("smoke_packed", t["q"], t["k"], t["v"]), ("smoke_bhnd", t["tq"], t["tk"], t["tv"])]
    del t
    return smoke + [("test_packed", *tests.round_shape_inputs())]


def main() -> int:
    import torch

    from shapley_vit_tpu_torch.ops import attention as att

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    ab.print_card()
    libs = ab.libraries("attention", att._FNS, sys.argv[1:])
    fns = {name: ab.entry(lib, "svt_attention_bhnd_bf16", att._FNS["svt_attention_bhnd_bf16"])
           for name, lib in libs.items()}
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

        def runner(which):
            def run():
                out = torch.empty_like(q)
                err = fns[which](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
                                 N * H * 64, 64, H * 64, 0.125, stream)
                if err:
                    raise RuntimeError(f"{which} kernel: cudaError {err}")
                return out
            return run

        for which in ab.order(fns):
            run = runner(which)
            got = run()
            torch.cuda.synchronize()
            exact_row = {"exact_max_abs_err": (got.double() - exact).abs().max().item(),
                         "exact_share_differing": (got != exact_bf16).float().mean().item()}
            del got
            print(json.dumps({"inputs": name, "kernel": which, "shape": list(q.shape),
                              **ab.measure(run, want, 20, 10), **exact_row}), flush=True)
        del exact, exact_bf16, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
