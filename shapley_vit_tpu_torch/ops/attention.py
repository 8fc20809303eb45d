"""Packed-layout multi-head attention, forward only.

The port of ``shapley_vit_tpu/ops/attention.py``'s v2 kernel
(``_attn_v2_kernel`` via ``fused_attention_packed``): q/k/v/o are
``[B, N, H·d]`` with the heads packed in the last axis, so no head
transposes sit around the projections. :func:`fused_attention_packed`
launches the hand-written Hopper kernel (``csrc/attention.cu``) for a CUDA
tensor and runs :func:`fused_attention_packed_plain` for a CPU tensor.

The JAX package's other attention kernel, ``_attn_kernel`` on ``[B, H, N, d]``
with its custom VJP, belongs to LoRA training and is ported with that slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from shapley_vit_tpu_torch.ops import _build

MASK = -1e30  # the Pallas kernel's value for masked (padded) keys

_FNS = {
    f"svt_attention_packed_{t}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p]
    for t in ("f32", "bf16")
}
_FNS["svt_attention_max_seq"] = []
_FNS["svt_attention_head_dim"] = []


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fused_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int) -> torch.Tensor:
    """The Pallas kernel's arithmetic in torch ops: keys padded to a multiple
    of 128 and masked to -1e30, scores, softmax and both products in
    float32, the output in q's dtype."""
    B, N, HD = q.shape
    d = HD // heads
    scale = 1.0 / math.sqrt(d)
    n_pad = _round_up(N, 128)

    def heads_f32(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, n_pad - N))
        return t.reshape(B, n_pad, heads, d).transpose(1, 2)  # [B, H, n_pad, d]

    qh, kh, vh = heads_f32(q), heads_f32(k), heads_f32(v)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    keep = torch.arange(n_pad, device=q.device) < N
    s = torch.where(keep, s, torch.tensor(MASK, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vh)  # [B, H, n_pad, d]
    return o.transpose(1, 2).reshape(B, n_pad, HD)[:, :N].to(q.dtype)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """Packed-layout fused MHA: q/k/v ``[B, N, H·d]`` -> ``[B, N, H·d]`` in q's
    dtype. CPU tensors run :func:`fused_attention_packed_plain`; CUDA
    tensors launch the kernel (float32 or bfloat16, contiguous, head dim 64,
    N <= 224)."""
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, heads)
    B, N, HD = q.shape
    if HD % heads:
        raise ValueError(f"width {HD} is not a multiple of {heads} heads")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    _build.check_tensors("fused_attention_packed", q, k, v)
    lib = _build.load("attention", _FNS)
    if HD // heads != lib.svt_attention_head_dim():
        raise ValueError(f"head dim {HD // heads} not supported "
                         f"(the kernel takes {lib.svt_attention_head_dim()})")
    if N > lib.svt_attention_max_seq():
        raise ValueError(f"sequence length {N} > {lib.svt_attention_max_seq()}")
    out = torch.empty_like(q)
    fn = getattr(lib, f"svt_attention_packed_{_build.SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, heads,
                 1.0 / math.sqrt(HD // heads), stream)
    _build.check(err, "fused_attention_packed")
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0
