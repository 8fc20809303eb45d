"""Fused LayerNorm -> MLP -> residual.

The port of ``shapley_vit_tpu/ops/mlp_block.py`` (Pallas ``_mlp_kernel`` via
``fused_mlp_block``): ``out = x + GELU(LN(x)·W1 + b1)·W2 + b2`` over
``[M, D]`` tokens. :func:`fused_mlp_block` launches the hand-written Hopper
kernels (``csrc/mlp_block.cu``) for a CUDA tensor and runs
:func:`fused_mlp_block_plain` for a CPU tensor. Forward only, as in the JAX
package: where autograd would need a gradient it raises (train with
``mlp_impl="xla"``).

On the card, :func:`mlp_route` picks the kernel from shape and dtype
before the launch:

* ``"wgmma"`` (bf16, D and the hidden width multiples of 8; the main
  path): LN into a bf16 workspace ``y [M, D]``, then two tensor-core
  GEMMs, fc1 (+ b1, GELU) into a bf16 workspace ``h [M, Hd]`` and fc2
  (+ b2, residual) into the output. Both workspaces come from PyTorch's
  caching allocator; y and h are rounded to bf16 where the Pallas kernel
  casts them to the weights' dtype, so the numerics are the fused
  kernel's.
* ``"tf32x3"`` (float32, D and the hidden width multiples of 4): the same
  LN and two GEMMs on the tensor cores in 3xTF32, each float32 operand
  split into a TF32 pair hi + lo and each product taken as hi·hi + hi·lo +
  lo·hi, which keeps float32's accuracy. Workspaces ``y [M, D]`` and
  ``h [M, Hd]`` in float32, and ``wt`` for W1's and W2's transposed TF32
  pairs (``4·D·Hd`` floats).
* ``"fma"`` (a hidden width that is not such a multiple, D a multiple of
  32 up to 1024): one kernel on the FMA units that keeps the hidden on
  chip.

The tensor-core routes read W1 and W2 by TMA, from 16-byte aligned
addresses: the wrapper first copies a weight that is not aligned to a
fresh allocation, so alignment never changes the route. Any other shape
raises a ``ValueError`` before any launch. The wrapper keeps the route of
its last launch in its ``route`` attribute, counts its launches in
``launches`` and, by kernel, in ``launches_by`` (``"<route> <dtype>"``).
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.ops import _build

_ARGS = [ctypes.c_void_p] * 8
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_FNS = {
    "svt_mlp_block_fma_f32": _ARGS + _TAIL,
    "svt_mlp_block_fma_bf16": _ARGS + _TAIL,
    "svt_mlp_block_bf16": _ARGS + [ctypes.c_void_p] * 2 + _TAIL,  # + the y and h workspaces
    "svt_mlp_block_tf32x3": _ARGS + [ctypes.c_void_p] * 3 + _TAIL,  # + y, h and wt
}
# the element multiple of D and the hidden width each tensor-core route needs
# (16-byte rows for TMA)
_TMA_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}
_TMA_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
FMA_MAX_WIDTH = 1024  # the FMA kernel's widest D (a multiple of 32)


def fused_mlp_block_plain(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, eps: float = 1e-12,
                          approximate_gelu: bool = False) -> torch.Tensor:
    """The Pallas kernel's arithmetic in torch ops: LN with float32
    statistics, y cast to W1's dtype, float32 accumulation and GELU, h cast
    to W2's dtype, float32 bias and residual, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    h = torch.matmul(y.to(w1.dtype).float(), w1.float()) + b1.float()
    h = F.gelu(h, approximate="tanh" if approximate_gelu else "none")
    out = torch.matmul(h.to(w2.dtype).float(), w2.float()) + b2.float()
    return (xf + out).to(x.dtype)


def mlp_route(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> str:
    """The kernel a call with these tensors takes on the card: ``"wgmma"``,
    ``"tf32x3"`` or ``"fma"`` (module docstring). Raises ``ValueError`` for
    a shape that none takes."""
    D, Hd = w1.shape
    mult = _TMA_MULTIPLE.get(x.dtype)
    if mult and D % mult == 0 and Hd % mult == 0:
        return _TMA_ROUTE[x.dtype]
    if D % 32 == 0 and 0 < D <= FMA_MAX_WIDTH:
        return "fma"
    raise ValueError(f"width {D} (hidden {Hd}, {x.dtype}) is taken by no kernel: the tensor cores "
                     f"need D and the hidden width multiples of 8 (bf16) or 4 (float32), else D "
                     f"must be a multiple of 32 up to {FMA_MAX_WIDTH}")


def fused_mlp_block(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    eps: float = 1e-12, approximate_gelu: bool = False) -> torch.Tensor:
    """``x [M, D] -> x + MLP(LN(x))``. CPU tensors run
    :func:`fused_mlp_block_plain`; CUDA tensors launch the kernels of
    :func:`mlp_route` (all seven tensors float32 or all bfloat16,
    contiguous). ``launches`` counts one per call."""
    _build.refuse_grad("fused_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2,
                       instead='mlp_impl="xla"')
    if not x.is_cuda:
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                                     approximate_gelu)
    M, D = x.shape
    Hd = w1.shape[1]
    if (ln_scale.shape != (D,) or ln_bias.shape != (D,) or w1.shape != (D, Hd)
            or b1.shape != (Hd,) or w2.shape != (Hd, D) or b2.shape != (D,)):
        raise ValueError("LN/fc1/fc2 shapes do not fit x [M, D]")
    _build.check_tensors("fused_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2)
    route = mlp_route(x, w1, w2)
    if route != "fma":  # the TMA reads W1 and W2 from 16-byte aligned addresses
        w1, w2 = (w if w.data_ptr() % 16 == 0 else w.clone() for w in (w1, w2))
    lib = _build.load("mlp_block", _FNS)
    out = torch.empty_like(x)
    args = [t.data_ptr() for t in (x, ln_scale, ln_bias, w1, b1, w2, b2, out)]
    tail = (M, D, Hd, float(eps), int(approximate_gelu))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "fma":
            fn = lib.svt_mlp_block_fma_f32 if x.dtype == torch.float32 else lib.svt_mlp_block_fma_bf16
            err = fn(*args, *tail, stream)
        else:
            # freed on return: the caching allocator hands their blocks only
            # to work queued after these kernels on this stream
            y = torch.empty((M, D), dtype=x.dtype, device=x.device)
            h = torch.empty((M, Hd), dtype=x.dtype, device=x.device)
            if route == "wgmma":
                err = lib.svt_mlp_block_bf16(*args, y.data_ptr(), h.data_ptr(), *tail, stream)
            else:
                wt = torch.empty((4, D, Hd), dtype=x.dtype, device=x.device)
                err = lib.svt_mlp_block_tf32x3(*args, y.data_ptr(), h.data_ptr(), wt.data_ptr(),
                                               *tail, stream)
    _build.check(err, "fused_mlp_block")
    fused_mlp_block.route = route
    fused_mlp_block.launches += 1
    fused_mlp_block.launches_by[f"{route} {str(x.dtype).replace('torch.', '')}"] += 1
    return out


fused_mlp_block.launches = 0
fused_mlp_block.launches_by = collections.Counter()
fused_mlp_block.route = None
