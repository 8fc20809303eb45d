#!/usr/bin/env python3
"""Share of bf16 attention outputs that differ from the plain version's, on
the bf16 tensor-core kernels, over many seeds, on one NVIDIA GPU.

    python3 tools/torch_attention_shares.py [--seeds S] [--wide]

Inputs: those of ``tests/test_torch_kernels.py``'s bf16 attention tests
(``numpy.random.default_rng(seed).normal``, as its ``_randn``; packed
``[B, N, H·d]``), at the shapes of ``test_attention_kernel_matches_plain``
(head dim 64; the round's [896, 197, 12 heads] left out) and of
``test_attention_narrow_head_dims`` (head dims 16 to 128) and of
``test_attention_wide_head_dims`` (bf16 head dims 136 to 512), for seeds 0
to S - 1 (default 32; the tests draw seed 1 and seed 12). Head dims are
zero-padded as the wrappers pad them, with the true head dim's scale.
``--wide`` runs the wide head dims alone.

Each shape up to head dim 128 runs on the key-loop kernel
(``svt_attention_bhnd_bf16_kl``); where the main paths' kernel
(``svt_attention_bhnd_bf16``) takes it too (padded head dim 64, N <= 224),
that one runs on the same inputs. Wider ones run on the wide kernel
(``svt_attention_bhnd_bf16_wide``). One JSON
line per shape and kernel: the share for each seed, their mean, the share
pooled over all seeds' outputs and that pool's binomial standard deviation.
Then one line per group (``paired``: the shapes both kernels take;
``n_past_224``; ``d128``: padded head dim 128 at N <= 224; ``wide``:
padded head dims 192 to 512) and kernel, pooled over its shapes and
seeds.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PACKED = [(3, 197, 12), (2, 100, 4), (2, 64, 2), (1, 224, 1), (1, 1, 2), (2, 8, 3), (3, 63, 4),
          (2, 65, 3), (133, 100, 1), (2, 225, 12), (2, 257, 12), (2, 577, 4)]
NARROW = [(3, 197, 2), (2, 17, 3), (896, 17, 2), (2, 225, 3), (2, 257, 2), (2, 577, 1)]
WIDE = [(3, 197, 2), (2, 17, 3), (2, 257, 2)]


def shapes(wide_only: bool):
    """(B, N, H, d) of the tests' bf16 tensor-core cases."""
    wide = [(B, N, H, d) for d in (136, 256, 384, 448, 512) for B, N, H in WIDE]
    if wide_only:
        return wide
    return [(B, N, H, 64) for B, N, H in PACKED] + [
        (B, N, H, d) for d in (16, 32, 80, 96, 128) for B, N, H in NARROW] + wide


def group(N: int, dk: int) -> str:
    if dk > 128:
        return "wide"
    if N > 224:
        return "n_past_224"
    return "paired" if dk == 64 else "d128"


def main() -> int:
    import torch

    from shapley_vit_tpu_torch.ops import _build
    from shapley_vit_tpu_torch.ops import attention as att

    argv = sys.argv[1:]
    seeds = int(argv[argv.index("--seeds") + 1]) if "--seeds" in argv else 32
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip(),
          flush=True)
    lib = _build.load("attention", att._FNS)
    stream = torch.cuda.current_stream().cuda_stream

    def run(entry, q, k, v, H, d):
        """The entry on packed q, k, v padded to the kernels' head dim."""
        B, N, _ = q.shape
        dk = att.kernel_head_dim(d)
        qp, kp, vp = (att.resize_heads(t, H, dk) for t in (q, k, v))
        out = torch.empty_like(qp)
        dims = (B, H, N) if entry == "bf16" else (B, H, N, dk)
        err = getattr(lib, f"svt_attention_bhnd_{entry}")(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), *dims, N * H * dk, dk,
            H * dk, 1.0 / math.sqrt(d), stream)
        _build.check(err, entry)
        return att.resize_heads(out, H, d)

    pools = {}
    for B, N, H, d in shapes("--wide" in argv):
        dk = att.kernel_head_dim(d)
        entries = (["bf16_wide"] if dk > 128 else
                   ["bf16_kl"] + (["bf16"] if dk == 64 and N <= 224 else []))
        shares = {e: [] for e in entries}
        for seed in range(seeds):
            rng = np.random.default_rng(seed)
            q, k, v = (torch.as_tensor(rng.normal(size=(B, N, H * d)), dtype=torch.float32)
                       .to("cuda", torch.bfloat16) for _ in range(3))
            want = att.fused_attention_packed_plain(q, k, v, heads=H)
            for e in entries:
                shares[e].append((run(e, q, k, v, H, d) != want).float().mean().item())
        n = B * N * H * d
        for e in entries:
            pooled = sum(shares[e]) / seeds
            print(json.dumps({"shape": [B, N, H, d], "kernel": e, "outputs_per_seed": n,
                              "seeds": seeds, "mean": pooled, "max": max(shares[e]),
                              "pooled_sigma": math.sqrt(pooled * (1 - pooled) / (n * seeds)),
                              "shares": shares[e]}), flush=True)
            pool = pools.setdefault((group(N, dk), e), [0.0, 0])
            pool[0] += pooled * n * seeds
            pool[1] += n * seeds
        torch.cuda.empty_cache()
    for (g, e), (differ, total) in pools.items():
        share = differ / total
        print(json.dumps({"group": g, "kernel": e, "outputs": total, "pooled_share": share,
                          "pooled_sigma": math.sqrt(share * (1 - share) / total)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
