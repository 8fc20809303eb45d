"""LayerNorm over the last axis, with float32 statistics.

:func:`layer_norm` launches the hand-written Hopper kernel
(``csrc/layer_norm.cu``) for a CUDA tensor and runs :func:`layer_norm_plain`,
the same arithmetic in torch ops, for a CPU tensor. The JAX package has no
LayerNorm kernel (its LN is ``jnp`` ops, which XLA fuses); the port's torch
ops are about twelve launches over the whole activation, so the merged
coalition forward's LN before attention and its final LN go through this
kernel. Forward only: where autograd would need a gradient it raises (train
with ``mlp_impl="xla"``, whose LN stays torch ops).

The arithmetic is :func:`layer_norm_plain`'s on both devices: float32 mean
and two-pass variance over the row, ``(x - mean) * rsqrt(var + eps) * scale
+ bias`` in float32 with ``scale`` and ``bias`` read as float32, the result
rounded to x's dtype; the kernel differs only in the order of the row's sums.

Rows that repeat along a leading axis of stride 0 (the embedding expanded
over the coalitions) are normalised once and the result is expanded the same
way. On the card the route follows the rows' shape (:func:`layer_norm_route`):
``"vector"`` (16-byte loads and stores, the row held in registers) where a
row and its stride are whole 16-byte vectors, x is 16-byte aligned and the row
is at most 2,048 bf16 or 1,024 float32 values; ``"scalar"`` otherwise. The
wrapper keeps the route of its last launch in its ``route`` attribute, counts
its launches in ``launches`` and, by kernel, in ``launches_by``
(``"<route> <dtype>"``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from shapley_vit_tpu_torch.ops import _build

_FNS = {
    f"svt_layer_norm_{sfx}": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for sfx in _build.SUFFIX.values()
}
_VECTOR_BYTES = 16
_MAX_VECTORS = 32 * 8  # a warp's lanes times the vectors a lane holds


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LN over the last axis in torch ops: float32 statistics whatever x's
    dtype, the result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _row_stride(rows: torch.Tensor) -> int:
    """The kernel's row stride of rows ``[M, D]``: a single row's is D,
    whatever torch records for it."""
    return rows.stride(0) if rows.shape[0] > 1 else rows.shape[1]


def layer_norm_route(rows: torch.Tensor) -> str:
    """The kernel that rows ``[M, D]`` (unit column stride) take on the card
    (module docstring)."""
    isz = rows.element_size()
    D = rows.shape[1]
    vector = (D * isz % _VECTOR_BYTES == 0 and _row_stride(rows) * isz % _VECTOR_BYTES == 0
              and rows.data_ptr() % _VECTOR_BYTES == 0
              and D * isz // _VECTOR_BYTES <= _MAX_VECTORS)
    return "vector" if vector else "scalar"


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LN of ``x [..., D]`` with ``scale`` and ``bias`` ``[D]``. CPU tensors
    run :func:`layer_norm_plain`; CUDA tensors (float32 or bfloat16 x) launch
    the kernel once. ``launches`` counts one per call on the card."""
    _build.refuse_grad("layer_norm", x, scale, bias, instead='mlp_impl="xla"')
    repeated = [d for d in range(x.dim() - 1) if x.stride(d) == 0 and x.shape[d] > 1]
    if repeated:
        distinct = x
        for d in repeated:
            distinct = distinct.narrow(d, 0, 1)
        return layer_norm(distinct, scale, bias, eps).expand(x.shape)
    if not x.is_cuda:
        return layer_norm_plain(x, scale, bias, eps)
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError("LN scale and bias must be [D] for x [..., D]")
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _build.check_tensors("layer_norm", x, contiguous=False)
    _build.check_tensors("layer_norm", scale, bias)
    if scale.device != x.device:
        raise ValueError(f"layer_norm: all tensors must be on {x.device}")
    rows = x.reshape(-1, D)
    if rows.stride(1) != 1 or _row_stride(rows) < D:
        rows = rows.contiguous()
    out = torch.empty(rows.shape, dtype=x.dtype, device=x.device)
    if rows.shape[0] == 0:
        return out.reshape(x.shape)
    route = layer_norm_route(rows)
    lib = _build.load("layer_norm", _FNS)
    entry = getattr(lib, f"svt_layer_norm_{_build.SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        err = entry(rows.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    rows.shape[0], D, _row_stride(rows), float(eps), int(route == "vector"),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(err, "layer_norm")
    _build.count(layer_norm, route, f"{route} {str(x.dtype).replace('torch.', '')}")
    return out.reshape(x.shape)


layer_norm.launches = 0
layer_norm.launches_by = collections.Counter()
layer_norm.route = None
