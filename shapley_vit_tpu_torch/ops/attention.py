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

The key-loop tensor-core kernels are built for head dims 64 and 128
(``HEAD_DIMS``), the bf16 wide one for multiples of 64 from 192 to
``WIDE_MAX``, the float32 wide one for every multiple of 64 from 192.
On the card a head dim under 64 is zero-padded to 64, one of 65 to 127 to
128, and one past 128 to a multiple of 64 (:func:`kernel_head_dim`), before
the launch and the output cut back (:func:`resize_heads`), with the true
head dim's scale, as the JAX wrappers pad d to a multiple of 128: zero
columns change neither q·kᵀ nor the kept columns of p·v. A head dim the
kernels take is launched as it is, without a copy. Any sequence length N
runs: every route but the main paths' walks the keys in blocks with an
online softmax, as the JAX kernels pad N with no cap.

:func:`attention_route` picks the kernel before the launch: ``"wgmma"``
(bf16 at head dim 64 and N <= 224; the main paths), ``"wgmma_kl"`` (bf16
at head dim 128 or past 224 keys), ``"wgmma_wide"`` (bf16 at head dims 192
to 512, any N), ``"tf32x3"`` (float32 at head dim 64 or 128, any N),
``"tf32x3_wide"`` (float32 past head dim 128, any head dim and N: Q and K
streamed in 32-column panels of d) or ``"fma"`` (bf16 past 512, the only
route on the FMA units). The tensor-core kernels read through the TMA:
the wrappers first copy tensors that it cannot read (pointers not 16-byte
aligned, strides not multiples of 16 bytes) to fresh contiguous ones. Each wrapper keeps the route of its
last launch in its ``route`` attribute, counts its launches in
``launches`` and, by kernel and shape, in ``launches_by`` (``"<route>
<dtype> d<padded head dim> n<N>"``).
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from shapley_vit_tpu_torch.ops import _build

MASK = -1e30  # the Pallas kernel's value for masked (padded) keys

_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
_SIG_END = [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]
# entry -> argtypes: (q, k, v, o, B, H, N, [d,] sb, sh, sn, scale, stream)
_FNS = {f"svt_attention_bhnd_{t}": _SIG + [ctypes.c_int] + _SIG_END
        for t in ("fma_bf16", "tf32x3", "tf32x3_wide", "bf16_kl", "bf16_wide")}
_FNS["svt_attention_bhnd_bf16"] = _SIG + _SIG_END  # head dim 64 only
HEAD_DIMS = (64, 128)  # the head dims the key-loop tensor-core kernels are built for
WIDE_STEP = 64         # head dims past 128 are padded to a multiple of this (the wide and FMA kernels')
WIDE_MAX = 512         # the bf16 wide tensor-core kernel's widest head dim (WIDE_MAX in csrc/attention.cu)
WGMMA_MAX_SEQ = 224    # the bf16 tensor-core kernel's longest N (MAX_KC * KC in csrc/attention.cu)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: 64 for 1 <= d <= 64,
    128 for 64 < d <= 128, d rounded up to a multiple of 64 past 128
    (narrower heads are zero-padded); ``ValueError`` for d < 1."""
    if d < 1:
        raise ValueError(f"head dim {d} not supported (the kernels take any head dim from 1)")
    return next((dk for dk in HEAD_DIMS if d <= dk), _round_up(d, WIDE_STEP))


def resize_heads(t: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """``t [..., heads·d] -> [..., heads·width]``: each head's d values
    zero-padded (width > d) or cut (width < d) to ``width``. With heads = 1
    it pads or cuts the last axis of ``[B, H, N, d]``."""
    *lead, hd = t.shape
    d = hd // heads
    t = t.reshape(*lead, heads, d)
    t = torch.nn.functional.pad(t, (0, width - d)) if width > d else t[..., :width]
    return t.reshape(*lead, heads * width)


def tma_readable(tensors, B: int, H: int, strides) -> bool:
    """Whether the TMA can read ``tensors`` with these batch and head extents and
    shared strides (batch, head, row; elements): 16-byte aligned pointers
    and strides that are multiples of 16 bytes, where the axis's extent is
    over 1 (the others are never used)."""
    sb, sh, sn = strides
    m = 16 // tensors[0].element_size()
    return (all(t.data_ptr() % 16 == 0 for t in tensors) and sn > 0 and sn % m == 0
            and (H == 1 or (sh > 0 and sh % m == 0)) and (B == 1 or (sb > 0 and sb % m == 0)))


def attention_route(dtype: torch.dtype, N: int, head_dim: int) -> str:
    """The kernel that q, k, v of ``dtype`` with N rows and padded
    ``head_dim`` take: up to head dim 128 ``"tf32x3"`` for float32,
    ``"wgmma"`` for bf16 at head dim 64 and N <= 224 and ``"wgmma_kl"`` for
    other bf16; past 128 ``"tf32x3_wide"`` for float32 (no cap),
    ``"wgmma_wide"`` for bf16 up to ``WIDE_MAX`` and ``"fma"`` for bf16
    past it. Every route but ``"fma"`` reads what the TMA can read
    (:func:`tma_readable`): the wrappers copy other tensors first."""
    if head_dim in HEAD_DIMS:
        if dtype == torch.float32:
            return "tf32x3"
        return "wgmma" if head_dim == 64 and N <= WGMMA_MAX_SEQ else "wgmma_kl"
    if dtype == torch.float32:
        return "tf32x3_wide"
    return "wgmma_wide" if head_dim <= WIDE_MAX else "fma"


_ENTRY = {"wgmma": "bf16", "wgmma_kl": "bf16_kl", "wgmma_wide": "bf16_wide", "tf32x3": "tf32x3",
          "tf32x3_wide": "tf32x3_wide", "fma": "fma_bf16"}


def _count(wrapper, route: str, q: torch.Tensor, d: int, N: int) -> None:
    """One launch of ``wrapper``'s kernel on ``route`` at padded head dim
    ``d`` and sequence length ``N``."""
    wrapper.route = route
    wrapper.launches += 1
    wrapper.launches_by[f"{route} {str(q.dtype).replace('torch.', '')} d{d} n{N}"] += 1


def _launch(what: str, q, k, v, out, B: int, H: int, N: int, d: int, strides,
            scale: float) -> str:
    """Launch the kernel of :func:`attention_route`; returns the route. q, k,
    v and out share ``strides`` (batch, head, row; in elements), and the
    padded head dim ``d`` is contiguous. ``scale`` is 1/√d of the caller's
    head dim, which may be narrower than the padded one."""
    lib = _build.load("attention", _FNS)
    route = attention_route(q.dtype, N, d)
    fn = getattr(lib, f"svt_attention_bhnd_{_ENTRY[route]}")
    dims = (B, H, N) if route == "wgmma" else (B, H, N, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims, *strides, scale,
                 stream)
    _build.check(err, what)
    return route


def fused_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """The Pallas kernel's arithmetic in torch ops: keys padded to a multiple
    of 128 and masked to -1e30, scores, softmax and both products in
    float32, the output in q's dtype. ``scale`` defaults to 1/√d."""
    B, N, HD = q.shape
    d = HD // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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
    tensors launch the kernel (float32 or bfloat16, contiguous, any head dim
    and N)."""
    _build.refuse_grad("fused_attention_packed", q, k, v, instead='attention_impl="pallas"')
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, heads)
    B, N, HD = q.shape
    if HD % heads:
        raise ValueError(f"width {HD} is not a multiple of {heads} heads")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    _build.check_tensors("fused_attention_packed", q, k, v)
    d = HD // heads
    dk = kernel_head_dim(d)
    if dk != d:
        q, k, v = (resize_heads(t, heads, dk) for t in (q, k, v))
    if attention_route(q.dtype, N, dk) != "fma":  # the TMA reads 16-byte aligned tensors only
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    # the packed layout as [B, H, N, d] strides: batch N·H·d, head d, row H·d
    route = _launch("fused_attention_packed", q, k, v, out, B, heads, N, dk,
                    (N * heads * dk, dk, heads * dk), 1.0 / math.sqrt(d))
    _count(fused_attention_packed, route, q, dk, N)
    return out if dk == d else resize_heads(out, heads, d)


fused_attention_packed.launches = 0
fused_attention_packed.launches_by = collections.Counter()
fused_attention_packed.route = None


# ---------------------------------------------------------------------------
# [B, H, N, d] attention with a gradient (``_attn_kernel`` + its custom VJP)
# ---------------------------------------------------------------------------

def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The Pallas ``_attn_kernel``'s arithmetic in torch ops, ``[B, H, N, d]``:
    keys padded to a multiple of 128 and masked to -inf, scores, softmax and
    both products in float32, the output in q's dtype; ``scale`` defaults
    to 1/√d. (The Pallas kernel also pads d to 128 with zeros, which adds
    exact zeros to every sum.)"""
    N = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
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
    layouts, and those of the tensor-core routes that the TMA cannot read,
    are copied to contiguous first. The output keeps q's strides. A head dim
    that the kernels do not take is zero-padded first (:func:`kernel_head_dim`;
    contiguous copies) and the output cut back."""
    B, H, N, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    dk = kernel_head_dim(d)
    if dk != d:
        q, k, v = (resize_heads(t, 1, dk) for t in (q, k, v))
    out = torch.empty_like(q)
    if not (q.stride() == k.stride() == v.stride() == out.stride() and q.stride(-1) == 1
            and (attention_route(q.dtype, N, dk) == "fma"
                 or tma_readable((q, k, v), B, H, q.stride()[:3]))):
        q, k, v = (t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
        out = torch.empty_like(q)
    _build.check_tensors("fused_attention", q, k, v, contiguous=False)
    route = _launch("fused_attention", q, k, v, out, B, H, N, dk, q.stride()[:3], 1.0 / math.sqrt(d))
    _count(fused_attention, route, q, dk, N)
    return out if dk == d else resize_heads(out, 1, d)


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
    bfloat16, any head dim and N). The backward recomputes with
    :func:`xla_attention` on either device."""
    return _FusedAttention.apply(q, k, v)


fused_attention.launches = 0
fused_attention.launches_by = collections.Counter()
fused_attention.route = None
