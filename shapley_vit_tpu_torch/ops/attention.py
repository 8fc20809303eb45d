"""Fused multi-head attention: the two kernels of
``shapley_vit_tpu/ops/attention.py``, both in ``csrc/attention.cu``.

* :func:`fused_attention_packed` (``_attn_v2_kernel``), the Shapley round's
  path, forward only: q/k/v/o are ``[B, N, H·d]`` with the heads packed in
  the last axis, so no head transposes sit around the projections.
* :func:`fused_attention` (``_attn_kernel`` with its custom VJP), the LoRA
  training path: q/k/v/o are ``[B, H, N, d]``. It is a
  ``torch.autograd.Function`` whose backward recomputes the attention with
  differentiable torch ops (:func:`xla_attention`), as the JAX package's
  ``_bwd`` does with XLA math: no attention matrix is saved.

Each launches its hand-written Hopper kernel for a CUDA tensor and runs its
plain version (:func:`fused_attention_packed_plain`,
:func:`fused_attention_plain`) for a CPU tensor. The packed kernel has no
gradient: called where autograd would need one, it raises rather than cut
the graph.
"""

from __future__ import annotations

import ctypes
import math

import torch

from shapley_vit_tpu_torch.ops import _build

MASK = -1e30  # the Pallas kernel's value for masked (padded) keys

_FNS = {
    f"svt_attention_bhnd_{t}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
    for t in ("f32", "bf16")
}
_FNS["svt_attention_max_seq"] = []
_FNS["svt_attention_head_dim"] = []


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _launch(what: str, q, k, v, out, B: int, H: int, N: int, d: int, strides) -> None:
    """Launch ``svt_attention_bhnd_*`` after checking the shape against what
    the kernels take. q, k, v and out share ``strides`` (batch, head, row;
    in elements), and the head dim is contiguous."""
    lib = _build.load("attention", _FNS)
    if d != lib.svt_attention_head_dim():
        raise ValueError(f"head dim {d} not supported "
                         f"(the kernel takes {lib.svt_attention_head_dim()})")
    if N > lib.svt_attention_max_seq():
        raise ValueError(f"sequence length {N} > {lib.svt_attention_max_seq()}")
    fn = getattr(lib, f"svt_attention_bhnd_{_build.SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
                 *strides, 1.0 / math.sqrt(d), stream)
    _build.check(err, what)


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
    _build.refuse_grad("fused_attention_packed", q, k, v, instead='attention_impl="pallas"')
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, heads)
    B, N, HD = q.shape
    if HD % heads:
        raise ValueError(f"width {HD} is not a multiple of {heads} heads")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    _build.check_tensors("fused_attention_packed", q, k, v)
    out = torch.empty_like(q)
    d = HD // heads
    # the packed layout as [B, H, N, d] strides: batch N·H·d, head d, row H·d
    _launch("fused_attention_packed", q, k, v, out, B, heads, N, d, (N * HD, d, HD))
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# [B, H, N, d] attention with a gradient (``_attn_kernel`` + its custom VJP)
# ---------------------------------------------------------------------------

def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The Pallas ``_attn_kernel``'s arithmetic in torch ops, ``[B, H, N, d]``:
    keys padded to a multiple of 128 and masked to -inf, scores, softmax and
    both products in float32, the output in q's dtype. (The Pallas kernel
    also pads d to 128 with zeros, which adds exact zeros to every sum.)"""
    N = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    n_pad = _round_up(N, 128)

    def padded(t):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, n_pad - N))

    qp, kp, vp = padded(q), padded(k), padded(v)
    s = torch.matmul(qp, kp.transpose(-1, -2)) * scale
    keep = torch.arange(n_pad, device=q.device) < N
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p, vp)[:, :, :N].to(q.dtype)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_xla_attention`` in differentiable torch ops
    (float32 scores, softmax and products; output in q's dtype): the
    recomputation that :func:`fused_attention`'s backward differentiates."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _attention_bhnd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors ``[B, H, N, d]``. q/k/v are read in
    place when they share their strides with a contiguous head dim (the
    views a head split makes of packed [B, N, H·d] projections); other
    layouts are copied to contiguous first. The output keeps q's strides."""
    B, H, N, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    out = torch.empty_like(q)
    if not (q.stride() == k.stride() == v.stride() == out.stride() and q.stride(-1) == 1):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
    _build.check_tensors("fused_attention", q, k, v, contiguous=False)
    _launch("fused_attention", q, k, v, out, B, H, N, d, q.stride()[:3])
    fused_attention.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward: the
    JAX VJP's recomputation, ``vjp(_xla_attention)``; it launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if not q.is_cuda:
            return fused_attention_plain(q, k, v)
        return _attention_bhnd_kernel(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = xla_attention(q, k, v)
        return torch.autograd.grad(o, (q, k, v), g)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused MHA with a gradient: q/k/v ``[B, H, N, d]`` -> context
    ``[B, H, N, d]`` in q's dtype. CPU tensors run
    :func:`fused_attention_plain`; CUDA tensors launch the kernel (float32 or
    bfloat16, head dim 64, N <= 224). The backward recomputes with
    :func:`xla_attention` on either device."""
    return _FusedAttention.apply(q, k, v)


fused_attention.launches = 0
