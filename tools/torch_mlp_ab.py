#!/usr/bin/env python3
"""Compare this tree's bf16 fused-MLP kernels with other versions of
``shapley_vit_tpu_torch/csrc/mlp_block.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/mlp_block.cu > exp/other_mlp_block.cu
    python3 tools/torch_mlp_ab.py exp/other_mlp_block.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py``, through
its ``svt_mlp_block_bf16`` entry: a source that has
``svt_mlp_block_fma_bf16`` takes the y and h workspaces (allocated here
with ``torch.empty``, as the wrapper does), an older one does not. The
inputs are the bf16 ones of ``chip_smoke.py``'s ``kernels`` phase
(``chip_smoke.kernel_inputs``, seed 0: x [176,512, 768], W1 [768, 3072],
W2 [3072, 768]). For each kernel one JSON line (``torch_kernel_ab.measure``:
error and share differing from the plain version, ms per call, ms among 15
back to back, host µs); the torch-op MLP half (``models.vit.mlp_half_xla``,
cuBLAS) runs first and last.
"""

from __future__ import annotations

import json
import sys

import torch_kernel_ab as ab

YARDSTICK = "mlp_half_xla"


def main() -> int:
    import torch

    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import mlp_block as mlp

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    ab.print_card()
    libs = ab.libraries("mlp_block", mlp._FNS, sys.argv[1:])
    t = ab.chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    args = [t[n] for n in ("x", "ls", "lb", "w1", "b1", "w2", "b2")]
    del t
    torch.cuda.empty_cache()
    x, w1 = args[0], args[3]
    M, D = x.shape
    Hd = w1.shape[1]
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib, name):
        workspaces = hasattr(lib, "svt_mlp_block_fma_bf16")  # else the signature without them
        fn = ab.entry(lib, "svt_mlp_block_bf16",
                      mlp._FNS["svt_mlp_block_bf16" if workspaces else "svt_mlp_block_fma_bf16"])

        def run():
            out = torch.empty_like(x)
            ptrs = [a.data_ptr() for a in (*args, out)]
            if workspaces:
                y = torch.empty((M, D), dtype=x.dtype, device="cuda")
                h = torch.empty((M, Hd), dtype=x.dtype, device="cuda")
                ptrs += [y.data_ptr(), h.data_ptr()]
            err = fn(*ptrs, M, D, Hd, 1e-12, 0, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out
        return run

    spec = tvit.make_spec("base", dtype="bfloat16")
    blk = {"ln2": {"scale": args[1], "bias": args[2]},
           "mlp": {"fc1": {"kernel": args[3], "bias": args[4]},
                   "fc2": {"kernel": args[5], "bias": args[6]}}}
    runs = {YARDSTICK: lambda: tvit.mlp_half_xla(x, blk, spec)}
    runs.update({name: runner(lib, name) for name, lib in libs.items()})
    for name in ab.order(libs, YARDSTICK):
        print(json.dumps({"kernel": name, "shape": [M, D, Hd],
                          **ab.measure(runs[name], want, 15, 5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
