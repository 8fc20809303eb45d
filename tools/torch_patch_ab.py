#!/usr/bin/env python3
"""Compare this tree's patch-embedding kernels with other versions of
``shapley_vit_tpu_torch/csrc/patch_embed.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/patch_embed.cu > exp/other_patch_embed.cu
    python3 tools/torch_patch_ab.py [--dtype float32] exp/other_patch_embed.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py`` on the
inputs of ``chip_smoke.py``'s ``kernels`` phase in the dtype
(``chip_smoke.kernel_inputs``, seed 0: [128, 224, 224, 3] images, a
[768, 768] kernel, 16-px patches). In bf16 (the default) through its
``svt_patch_embed_bf16`` entry (the C signature has not changed); in
float32 through ``svt_patch_embed_tf32x3`` with the workspace of W's TF32
pair where the source has it, else through the FMA kernel's
``svt_patch_embed_f32``. For each kernel one JSON line
(``torch_kernel_ab.measure``: error and share differing from the plain
version, ms per call, ms among 100 back to back, host µs, and whether the
output is bit-identical to this tree's kernel's); ``F.conv2d``
(cuDNN, TF32 off) runs first and last, and in float32 the plain version
(``patch_embed_plain``: the patchify copy, one cuBLAS SGEMM with TF32 off,
the bias) second and second to last.
"""

from __future__ import annotations

import json
import sys

import torch_kernel_ab as ab


def main() -> int:
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import patch_embed as pe

    argv = sys.argv[1:]
    dname = "bfloat16"
    if argv[:1] == ["--dtype"]:
        dname, argv = argv[1], argv[2:]
    if not argv or dname not in ("bfloat16", "float32") or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dtype = getattr(torch, dname)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ab.print_card()
    libs = ab.libraries("patch_embed", pe._FNS, argv)
    t = ab.chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), dtype)
    img, w, b = t["img"], t["pw"], t["pb"]
    del t
    torch.cuda.empty_cache()
    B, H, W, C = img.shape
    P, D = ab.chip_smoke.P, w.shape[1]
    want = pe.patch_embed_plain(img, w, b, P)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib, name):
        if dtype == torch.bfloat16:
            fn, wt = ab.entry(lib, "svt_patch_embed_bf16", pe._FNS["svt_patch_embed_bf16"]), []
        elif hasattr(lib, "svt_patch_embed_tf32x3"):
            fn = ab.entry(lib, "svt_patch_embed_tf32x3", pe._FNS["svt_patch_embed_tf32x3"])
            wt = [(2, D, -(-P * P * C // 4) * 4)]
        else:  # the FMA kernel's entry, which has the bf16 entry's signature
            fn, wt = ab.entry(lib, "svt_patch_embed_f32", pe._FNS["svt_patch_embed_bf16"]), []

        def run():
            out = torch.empty((B, (H // P) * (W // P), D), dtype=img.dtype, device="cuda")
            work = [torch.empty(s, dtype=torch.float32, device="cuda") for s in wt]
            err = fn(img.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                     *(t.data_ptr() for t in work), B, H, W, C, P, D, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out
        return run

    conv_w = w.reshape(P, P, C, D).permute(3, 2, 0, 1).contiguous()
    nchw = img.permute(0, 3, 1, 2)
    runs = {"F.conv2d": lambda: F.conv2d(nchw, conv_w, b, stride=P),
            "plain": lambda: pe.patch_embed_plain(img, w, b, P)}
    runs.update({name: runner(lib, name) for name, lib in libs.items()})
    names = ab.order(libs, "F.conv2d")
    if dtype == torch.float32:
        names = [names[0], "plain", *names[1:-1], "plain", names[-1]]
    first = runs["this"]()
    for name in names:
        layout = (lambda o: o.permute(0, 2, 3, 1).reshape(want.shape)) if name == "F.conv2d" else None
        got = runs[name]()
        same = bool(torch.equal(got if layout is None else layout(got), first))
        del got
        print(json.dumps({"kernel": name, "dtype": dname, "shape": list(img.shape),
                          "bit_identical_to_this": same,
                          **ab.measure(runs[name], want, 100, 20, layout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
