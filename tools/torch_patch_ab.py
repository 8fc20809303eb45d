#!/usr/bin/env python3
"""Compare this tree's bf16 patch-embedding kernel with other versions of
``shapley_vit_tpu_torch/csrc/patch_embed.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/patch_embed.cu > exp/other_patch_embed.cu
    python3 tools/torch_patch_ab.py exp/other_patch_embed.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py``, through
its ``svt_patch_embed_bf16`` entry (the C signature has not changed), on
the bf16 inputs of ``chip_smoke.py``'s ``kernels`` phase
(``chip_smoke.kernel_inputs``, seed 0: [128, 224, 224, 3] images, a
[768, 768] kernel, 16-px patches). For each kernel one JSON line
(``torch_kernel_ab.measure``: error and share differing from the plain
version, ms per call, ms among 100 back to back, host µs); ``F.conv2d``
(cuDNN) runs first and last.
"""

from __future__ import annotations

import json
import sys

import torch_kernel_ab as ab


def main() -> int:
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import patch_embed as pe

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    ab.print_card()
    libs = ab.libraries("patch_embed", pe._FNS, sys.argv[1:])
    t = ab.chip_smoke.kernel_inputs(torch.Generator(device="cuda").manual_seed(0), torch.bfloat16)
    img, w, b = t["img"], t["pw"], t["pb"]
    del t
    torch.cuda.empty_cache()
    B, H, W, C = img.shape
    P, D = ab.chip_smoke.P, w.shape[1]
    want = pe.patch_embed_plain(img, w, b, P)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib, name):
        fn = ab.entry(lib, "svt_patch_embed_bf16", pe._FNS["svt_patch_embed_bf16"])

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
    runs.update({name: runner(lib, name) for name, lib in libs.items()})
    for name in ab.order(libs, "F.conv2d"):
        layout = (lambda o: o.permute(0, 2, 3, 1).reshape(want.shape)) if name == "F.conv2d" else None
        print(json.dumps({"kernel": name, "shape": list(img.shape),
                          **ab.measure(runs[name], want, 100, 20, layout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
