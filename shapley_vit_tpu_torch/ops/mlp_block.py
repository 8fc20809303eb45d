"""Fused LayerNorm -> MLP -> residual.

The port of ``shapley_vit_tpu/ops/mlp_block.py`` (Pallas ``_mlp_kernel`` via
``fused_mlp_block``): ``out = x + GELU(LN(x)·W1 + b1)·W2 + b2`` over
``[M, D]`` tokens, the ``[M, 4D]`` hidden never written to device memory.
:func:`fused_mlp_block` launches the hand-written Hopper kernel
(``csrc/mlp_block.cu``) for a CUDA tensor and runs
:func:`fused_mlp_block_plain` for a CPU tensor. Forward only, as in the JAX
package: where autograd would need a gradient it raises (train with
``mlp_impl="xla"``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.ops import _build

_FNS = {
    f"svt_mlp_block_{t}": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for t in ("f32", "bf16")
}
_KERNEL_WIDTHS = (384, 768, 1024)  # D values the kernel is instantiated for


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


def fused_mlp_block(x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    eps: float = 1e-12, approximate_gelu: bool = False) -> torch.Tensor:
    """``x [M, D] -> x + MLP(LN(x))``. CPU tensors run
    :func:`fused_mlp_block_plain`; CUDA tensors launch the kernel (all seven
    tensors float32 or all bfloat16, contiguous, D in 384/768/1024)."""
    _build.refuse_grad("fused_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2,
                       instead='mlp_impl="xla"')
    if not x.is_cuda:
        return fused_mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
                                     approximate_gelu)
    M, D = x.shape
    Hd = w1.shape[1]
    if D not in _KERNEL_WIDTHS:
        raise ValueError(f"width {D} not supported by the kernel ({_KERNEL_WIDTHS})")
    if (ln_scale.shape != (D,) or ln_bias.shape != (D,) or w1.shape != (D, Hd)
            or b1.shape != (Hd,) or w2.shape != (Hd, D) or b2.shape != (D,)):
        raise ValueError("LN/fc1/fc2 shapes do not fit x [M, D]")
    _build.check_tensors("fused_mlp_block", x, ln_scale, ln_bias, w1, b1, w2, b2)
    lib = _build.load("mlp_block", _FNS)
    out = torch.empty_like(x)
    fn = getattr(lib, f"svt_mlp_block_{_build.SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), M, D, Hd,
                 float(eps), int(approximate_gelu), stream)
    _build.check(err, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0
