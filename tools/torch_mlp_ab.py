#!/usr/bin/env python3
"""Compare this tree's fused-MLP kernels with other versions of
``shapley_vit_tpu_torch/csrc/mlp_block.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/mlp_block.cu > exp/other_mlp_block.cu
    python3 tools/torch_mlp_ab.py [--dtype float32] [--unaligned] exp/other_mlp_block.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py``. In bf16
(the default) through its ``svt_mlp_block_bf16`` entry: a source that has
``svt_mlp_block_fma_bf16`` takes the y and h workspaces (allocated here
with ``torch.empty``, as the wrapper does), an older one does not. In
float32 through ``svt_mlp_block_tf32x3`` with the y, h and wt workspaces
where the source has it, else through the FMA kernel's float32 entry
(``svt_mlp_block_fma_f32``, or ``svt_mlp_block_f32`` in older sources). The
inputs are those of ``chip_smoke.py``'s ``kernels`` phase in the dtype
(``chip_smoke.kernel_inputs``, seed 0: x [176,512, 768], W1 [768, 3072],
W2 [3072, 768]). For each kernel one JSON line (``torch_kernel_ab.measure``:
error and share differing from the plain version, ms per call, ms among 15
back to back, host µs, and whether the output is bit-identical to this
tree's); the torch-op MLP half (``models.vit.mlp_half_xla``,
cuBLAS; float32 products in full float32) runs first and last.

``--unaligned``: W1 and W2 one element past an aligned allocation, which
the TMA cannot read. This tree runs its wrapper, ``fused_mlp_block`` (a
copy of each weight, then the dtype's tensor-core route); each other
source runs its FMA entry on the same weights, which is what wrappers
before the copy launched for them.
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

    argv = sys.argv[1:]
    dname = "bfloat16"
    if argv[:1] == ["--dtype"]:
        dname, argv = argv[1], argv[2:]
    unaligned = argv[:1] == ["--unaligned"]
    argv = argv[1:] if unaligned else argv
    if not argv or dname not in ("bfloat16", "float32") or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dtype = getattr(torch, dname)
    assert not torch.backends.cuda.matmul.allow_tf32  # the yardstick in full float32
    ab.print_card()
    libs = ab.libraries("mlp_block", mlp._FNS, argv)
    t = ab.chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), dtype)
    args = [t[n] for n in ("x", "ls", "lb", "w1", "b1", "w2", "b2")]
    del t
    if unaligned:
        args[3], args[5] = ab.chip_smoke.unaligned(args[3]), ab.chip_smoke.unaligned(args[5])
    torch.cuda.empty_cache()
    x, w1 = args[0], args[3]
    M, D = x.shape
    Hd = w1.shape[1]
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12)
    stream = torch.cuda.current_stream().cuda_stream

    def workspaces(shapes):
        return [torch.empty(shape, dtype=dtype, device="cuda") for shape in shapes]

    def runner(lib, name):
        if unaligned and name == "this":
            return lambda: mlp.fused_mlp_block(*args, eps=1e-12)
        if unaligned:
            entry = "svt_mlp_block_fma_" + ("f32" if dtype == torch.float32 else "bf16")
            fn = ab.entry(lib, entry, mlp._FNS[entry])
            shapes = []
        elif dtype == torch.float32:
            if hasattr(lib, "svt_mlp_block_tf32x3"):
                fn = ab.entry(lib, "svt_mlp_block_tf32x3", mlp._FNS["svt_mlp_block_tf32x3"])
                shapes = [(M, D), (M, Hd), (4, D, Hd)]
            else:
                entry = "svt_mlp_block_fma_f32" if hasattr(lib, "svt_mlp_block_fma_f32") \
                    else "svt_mlp_block_f32"
                fn = ab.entry(lib, entry, mlp._FNS["svt_mlp_block_fma_f32"])
                shapes = []
        elif hasattr(lib, "svt_mlp_block_fma_bf16"):
            fn = ab.entry(lib, "svt_mlp_block_bf16", mlp._FNS["svt_mlp_block_bf16"])
            shapes = [(M, D), (M, Hd)]
        else:  # the signature without workspaces
            fn = ab.entry(lib, "svt_mlp_block_bf16", mlp._FNS["svt_mlp_block_fma_bf16"])
            shapes = []

        def run():
            out = torch.empty_like(x)
            ptrs = [a.data_ptr() for a in (*args, out, *workspaces(shapes))]
            err = fn(*ptrs, M, D, Hd, 1e-12, 0, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out
        return run

    spec = tvit.make_spec("base", dtype=dname)
    blk = {"ln2": {"scale": args[1], "bias": args[2]},
           "mlp": {"fc1": {"kernel": args[3], "bias": args[4]},
                   "fc2": {"kernel": args[5], "bias": args[6]}}}
    runs = {YARDSTICK: lambda: tvit.mlp_half_xla(x, blk, spec)}
    runs.update({name: runner(lib, name) for name, lib in libs.items()})
    first = runs["this"]()
    for name in ab.order(libs, YARDSTICK):
        same = bool(torch.equal(runs[name](), first))
        print(json.dumps({"kernel": name, "dtype": dname, "shape": [M, D, Hd],
                          "weights": "unaligned" if unaligned else "aligned",
                          "bit_identical_to_this": same,
                          **ab.measure(runs[name], want, 15, 5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
