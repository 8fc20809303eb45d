#!/usr/bin/env python3
"""Where the float32 wide attention kernel's time goes, on one NVIDIA GPU.

    python3 tools/torch_attention_ablate.py

Builds this tree's ``shapley_vit_tpu_torch/csrc/attention.cu`` again with
one part of ``attention_tf32x3_wide_kernel``'s work cut out by an
``SVT_ABLATE_*`` macro (the outputs are wrong; the times say what the part
costs), and times each build's ``svt_attention_bhnd_tf32x3_wide`` entry
beside the normal build's at ``chip_smoke.LONG_ATTENTION``'s 64-image
shapes past head dim 128 (N = 197: 4 heads of 192, 3 of 256, 2 of 384, 1 of
512 and 1 of 576), in turns (``tools/torch_kernel_ab.order``: this, the
cuts, the cuts, this; ``F.scaled_dot_product_attention`` first and last).
The cuts:

* ``no_q_load``: the TMA loads of Q's panels (the loads of K stay);
* ``no_split``: the producer's TF32 split of K's panels and V's blocks;
* ``no_s_products``: 11 of each 32-column panel's 12 products of S;
* ``no_pv_products``: 2 of each 8-key step's 3 products of P V;
* ``skeleton``: the last three together, what the loads, waits and
  hand-overs take alone.

One JSON line per shape: the device ms of each (``chip_smoke.device_ms``,
the kernel alone among 20 calls back to back), once per turn.
"""

from __future__ import annotations

import json
import math
import sys

import torch_kernel_ab as ab

CUTS = {
    "no_q_load": ["NO_Q_LOAD"],
    "no_split": ["NO_SPLIT"],
    "no_s_products": ["NO_S_PRODUCTS"],
    "no_pv_products": ["NO_PV_PRODUCTS"],
    "skeleton": ["NO_SPLIT", "NO_S_PRODUCTS", "NO_PV_PRODUCTS"],
}
YARDSTICK = "sdpa"


def main() -> int:
    import torch
    import torch.nn.functional as F

    from shapley_vit_tpu_torch.ops import attention as att

    if sys.argv[1:] or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    ab.print_card()
    libs = ab.libraries("attention", att._FNS,
                        variants={name: [f"-DSVT_ABLATE_{m}" for m in ms] for name, ms in CUTS.items()})
    entry = "svt_attention_bhnd_tf32x3_wide"
    fns = {name: ab.entry(lib, entry, att._FNS[entry]) for name, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for tag, (n, h, d) in ab.chip_smoke.LONG_ATTENTION.items():
        if d <= 128:
            continue
        B = ab.chip_smoke.TB
        q, k, v = (torch.randn((B, n, h * d), generator=gen, device="cuda") for _ in range(3))
        views = [t.view(B, n, h, d).transpose(1, 2) for t in (q, k, v)]

        def runner(which):
            if which == YARDSTICK:
                return lambda: F.scaled_dot_product_attention(*views)
            fn = fns[which]

            def run():
                out = torch.empty_like(q)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, h, n, d,
                         n * h * d, d, h * d, 1.0 / math.sqrt(d), stream)
                if err:
                    raise RuntimeError(f"{which}: cudaError {err}")
                return out
            return run

        row = {"inputs": tag, "shape": [B, h, n, d]}
        for which in ab.order(fns, YARDSTICK):
            row.setdefault(f"{which}_device_ms", []).append(ab.chip_smoke.device_ms(runner(which), 20)[0])
        print(json.dumps(row), flush=True)
        del q, k, v, views
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
