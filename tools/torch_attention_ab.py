#!/usr/bin/env python3
"""Compare this tree's attention kernels with other versions of
``shapley_vit_tpu_torch/csrc/attention.cu`` on one NVIDIA GPU.

    git show <rev>:shapley_vit_tpu_torch/csrc/attention.cu > exp/other_attention.cu
    python3 tools/torch_attention_ab.py [--long | --wide | --stream] [--dtype float32] exp/other_attention.cu [more.cu ...]

Each other source is built and run by ``tools/torch_kernel_ab.py`` with the
packed layout's strides, as ``fused_attention_packed`` calls it.

* bf16 (the default): each source through its ``svt_attention_bhnd_bf16``
  entry, the main paths' kernel (the C signature is the same in all), and
  this tree's key-loop kernel (``svt_attention_bhnd_bf16_kl``) beside them
  as ``this_kl``. Inputs: those of ``chip_smoke.py``'s ``kernels`` phase
  (``chip_smoke.kernel_inputs``: ``smoke_packed`` [896, 197, 768] and
  ``smoke_bhnd``, the [64, 12, 197, 64] training batch, packed), those of
  ``tests/test_torch_kernels.py::test_attention_bf16_error_at_the_round_shape``
  (``round_shape_inputs``; ``test_packed``) and ``n216`` [64, 216, 768]
  (14 key chunks, the main paths' kernel's longest instance), 12 heads.
* ``--long``: bf16 at ``chip_smoke.LONG_ATTENTION``'s shapes up to head
  dim 128 (64 images: N = 257 and 577 with 12 heads of 64, 6 heads of 128
  at N = 197), each source through its ``svt_attention_bhnd_bf16_kl`` entry,
  or through its FMA entry ``svt_attention_bhnd_fma_bf16`` where it has
  none.
* ``--wide``: bf16 at ``chip_smoke.LONG_ATTENTION``'s head dims from 192
  to 512 (64 images, N = 197: 4 heads of 192, 3 of 256, 2 of 384, 1 of
  512), each source through its ``svt_attention_bhnd_bf16_wide`` entry, or
  through its FMA entry ``svt_attention_bhnd_fma_bf16`` where it has none,
  and this tree's streamed kernel beside them as ``this_stream`` (a build
  of this tree's source with ``-DSVT_STREAM_FROM_192``, whose
  ``svt_attention_bhnd_bf16_stream`` entry also takes these head dims).
  Each line also has the least time the card could take (``bound_ms``:
  the bytes of q, k, v and o over 3.35 TB/s against 4 B H N² d FLOP over
  989 TFLOP/s).
* ``--stream``: bf16 at the head dims past 512 of
  ``chip_smoke.LONG_ATTENTION`` and ``chip_smoke.STREAM_ATTENTION`` (64
  images, N = 197: 1 head of 576, 640 and 1024), each source through its
  ``svt_attention_bhnd_bf16_stream`` entry, or through its FMA entry
  ``svt_attention_bhnd_fma_bf16`` where it has none; ``bound_ms`` as
  under ``--wide``.
* ``--wide --dtype float32``: float32 at every head dim of
  ``chip_smoke.LONG_ATTENTION`` past 128 (the four above and 1 head of
  576), each source through its ``svt_attention_bhnd_tf32x3_wide`` entry,
  or through its FMA entry ``svt_attention_bhnd_fma_f32`` where it has
  none; ``bound_ms`` counts three TF32 products at 495 TFLOP/s for each
  float32 one (``chip_smoke.peak_ops``).
* ``--dtype float32`` alone: through ``svt_attention_bhnd_tf32x3`` where
  the source has it, else through the FMA kernel's
  ``svt_attention_bhnd_f32`` (in sources without the tensor-core route that
  entry takes no head dim), on chip_smoke's inputs.

For each kernel and input, one JSON line (``torch_kernel_ab.measure``:
error and share differing from the plain version's output, ms per call, ms
among 20 back to back, host µs, device ms from ``torch.profiler``) and the
same two errors against the float64 result (``exact_*``: the exact value
rounded to the dtype), and whether its output is bit-identical to this
tree's kernel's (``this``: the main paths' kernel, the key-loop one under
``--long``, the wide one of the dtype under ``--wide``, the streamed one
under ``--stream``).
``F.scaled_dot_product_attention`` on the same inputs runs first and last
(float32 products in full float32).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys

import torch_kernel_ab as ab

YARDSTICK = "sdpa"


def inputs(dtype, mode: str):
    """(name, q, k, v, heads), packed [B, N, heads·d] in ``dtype``."""
    import torch

    from shapley_vit_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    if mode in ("long", "wide", "stream"):
        widest = att.WIDE_MAX if dtype == torch.bfloat16 else math.inf
        low, high = {"long": (0, 128), "wide": (128, widest), "stream": (att.WIDE_MAX, math.inf)}[mode]
        shapes = {**ab.chip_smoke.LONG_ATTENTION, **ab.chip_smoke.STREAM_ATTENTION}
        return [(tag, *(torch.randn((ab.chip_smoke.TB, n, h * d), generator=gen, device="cuda")
                        .to(dtype) for _ in range(3)), h)
                for tag, (n, h, d) in shapes.items() if low < d <= high]
    path = os.path.join(ab.ROOT, "tests", "test_torch_kernels.py")
    spec = importlib.util.spec_from_file_location("test_torch_kernels", path)
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    t = ab.chip_smoke.kernel_inputs(gen, dtype)
    smoke = [("smoke_packed", t["q"], t["k"], t["v"], 12), ("smoke_bhnd", t["tq"], t["tk"], t["tv"], 12)]
    del t
    if dtype != torch.bfloat16:
        return smoke
    n216 = [torch.randn((64, 216, 768), generator=gen, device="cuda").to(dtype) for _ in range(3)]
    return smoke + [("test_packed", *tests.round_shape_inputs(), 12), ("n216", *n216, 12)]


def main() -> int:
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att

    argv = sys.argv[1:]
    dname, mode = "bfloat16", "main"
    while argv[:1] in (["--dtype"], ["--long"], ["--wide"], ["--stream"]):
        if argv[0] == "--dtype":
            dname, argv = (argv[1] if len(argv) > 1 else ""), argv[2:]
        else:
            mode, argv = argv[0][2:], argv[1:]
    if (not argv or dname not in ("bfloat16", "float32")
            or (mode in ("long", "stream") and dname == "float32") or not torch.cuda.is_available()):
        print(__doc__, file=sys.stderr)
        return 2
    dtype = getattr(torch, dname)
    assert not torch.backends.cuda.matmul.allow_tf32  # the yardstick in full float32
    ab.print_card()
    stream_variant = mode == "wide" and dtype == torch.bfloat16
    libs = ab.libraries("attention", att._FNS, argv,
                        variants={"this_stream": ["-DSVT_STREAM_FROM_192"]} if stream_variant else None)
    stream = torch.cuda.current_stream().cuda_stream
    with_d = att._FNS["svt_attention_bhnd_tf32x3"]

    def entry(which, lib):
        """(C entry, whether it takes the head dim)"""
        if mode == "wide" and dtype == torch.float32:
            name = "svt_attention_bhnd_tf32x3_wide"
            return ab.entry(lib, name if hasattr(lib, name) else "svt_attention_bhnd_fma_f32", with_d), True
        if mode != "main":
            kind = {"long": "kl", "wide": "wide", "stream": "stream"}[mode]
            name = "svt_attention_bhnd_bf16_" + ("stream" if which == "this_stream" else kind)
            return ab.entry(lib, name if hasattr(lib, name) else "svt_attention_bhnd_fma_bf16", with_d), True
        if dtype == torch.bfloat16:
            return ab.entry(lib, "svt_attention_bhnd_bf16", att._FNS["svt_attention_bhnd_bf16"]), False
        if hasattr(lib, "svt_attention_bhnd_tf32x3"):
            return ab.entry(lib, "svt_attention_bhnd_tf32x3", with_d), True
        return ab.entry(lib, "svt_attention_bhnd_f32", att._FNS["svt_attention_bhnd_bf16"]), False

    fns = {name: entry(name, lib) for name, lib in libs.items()}
    if dtype == torch.bfloat16 and mode == "main":
        fns["this_kl"] = ab.entry(libs["this"], "svt_attention_bhnd_bf16_kl", with_d), True
    pk = ab.chip_smoke.peaks(torch.cuda.get_device_name(0))

    for name, q, k, v, H in inputs(dtype, mode):
        B, N, HD = q.shape
        d = HD // H
        scale = 1.0 / math.sqrt(d)
        views = [t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v)]
        want = att.fused_attention_packed_plain(q, k, v, heads=H)
        qd, kd, vd = (t.double() for t in views)
        exact = (torch.softmax(qd @ kd.transpose(-1, -2) * scale, -1) @ vd)
        exact = exact.transpose(1, 2).reshape(B, N, H * d)
        del qd, kd, vd
        exact_rounded = exact.to(dtype)
        bound = {}
        if mode in ("wide", "stream"):
            route = "tf32x3_wide" if dtype == torch.float32 else f"wgmma_{mode}"
            bound["bound_ms"] = 1e3 * max(4 * q.numel() * q.element_size() / pk["bytes"],
                                          ab.chip_smoke.peak_ops(pk, dname, route, 4.0 * B * H * N * N * d))

        def runner(which):
            fn, takes_d = fns[which]
            dims = (B, H, N, d) if takes_d else (B, H, N)

            def run():
                out = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
                         N * H * d, d, H * d, scale, stream)
                if err:
                    raise RuntimeError(f"{which} kernel: cudaError {err}")
                return out
            return run

        runs = {name_: runner(name_) for name_ in fns}
        runs[YARDSTICK] = lambda: F.scaled_dot_product_attention(*views)

        def packed(o):
            return o.transpose(1, 2).reshape(B, N, H * d)

        first = runs["this"]()
        for which in ab.order(fns, YARDSTICK):
            layout = packed if which == YARDSTICK else None
            got = runs[which]()
            got = got if layout is None else layout(got)
            torch.cuda.synchronize()
            exact_row = {"exact_max_abs_err": (got.double() - exact).abs().max().item(),
                         "exact_share_differing": (got != exact_rounded).float().mean().item(),
                         "bit_identical_to_this": bool(torch.equal(got, first))}
            del got
            print(json.dumps({"inputs": name, "kernel": which, "dtype": dname, "shape": list(q.shape),
                              "heads": H, **ab.measure(runs[which], want, 20, 10, layout),
                              **exact_row, **bound}),
                  flush=True)
        del exact, exact_rounded, want, runs, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
