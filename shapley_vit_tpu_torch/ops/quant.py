"""Dynamic int8 (W8A8) matmul for the coalition-eval fast path.

The port of ``shapley_vit_tpu/ops/quant.py``, an AQT-style scheme:

  * activations: dynamic symmetric per-row scales (over the last dim);
  * weights: symmetric per-output-channel scales, quantized at each call (so
    weight trees, checkpoints and the coalition algebra stay float);
  * accumulation in int32, then ``acc · s_x · s_w`` and the bias in float32.

The int8 × int8 → int32 product is ``torch._int_mm`` on either device (the
JAX package computes it with ``lax.dot_general`` outside any Pallas kernel,
quant.py:55-60; on the card it runs on the H100's int8 tensor cores through
cuBLASLt). ``_int_mm`` takes 2-D operands only, and on the card it needs
more than 16 rows and K and N that are multiples of 8, so:

  * a shared ``[K, N]`` kernel folds every leading axis of ``x`` into rows;
  * a per-coalition ``[C, K, N]`` kernel (the merged q/v kernels) runs one
    product per coalition, over ``x [C, ..., K]``, each with its own scales
    (the JAX package ``vmap``s the coalition axis);
  * calls with fewer than 17 rows are padded with zero rows, which quantize
    to zero codes and add nothing;
  * K and N that are not multiples of 8 are padded with zero codes up to
    the next multiple, and N is cut back after the product: zero codes add
    nothing to the int32 sums, so the result is exact at any K and N.

The scales, the rounding (``torch.round`` rounds half to even, as
``jnp.round`` does) and the float32 rescale are elementwise torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_MIN_ROWS = 17        # _int_mm on the card needs more than 16 rows
_INT32_MAX = 2**31 - 1


def quantize_symmetric(x: torch.Tensor, dim, bound: float = 127.0):
    """Symmetric int8 quantization along ``dim`` (kept dims): returns
    (int8 values, float32 scale with keepdims)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    # divide by a tensor on amax's device: PyTorch turns a CUDA tensor's
    # division by a Python number into a product with its reciprocal, one
    # ulp off the true quotient that the CPU (and JAX) compute
    scale = torch.clamp_min(amax, 1e-12) / amax.new_full((), bound)
    q = torch.clamp(torch.round(xf / scale), -bound, bound).to(torch.int8)
    return q, scale


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [K, N]`` in int8 with int32 accumulation through
    ``torch._int_mm``; rows up to the 17 the card needs, and K and N up to
    multiples of 8, are padded with zero codes and cut off again. Raises
    when K·127² could overflow int32."""
    M, K = xq.shape
    N = wq.shape[1]
    if K * 127 * 127 > _INT32_MAX:
        raise ValueError(f"int8 matmul with K={K} could overflow its int32 accumulator")
    pad_k, pad_n, pad_m = -K % 8, -N % 8, max(_MIN_ROWS - M, 0)
    # (columns, rows): aligned operands are passed on as they are
    if pad_k or pad_m:
        xq = F.pad(xq, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        wq = F.pad(wq, (0, pad_n, 0, pad_k))
    # the weight column-major ([N, K] row-major, transposed): cuBLASLt's
    # int8 layout
    acc = torch._int_mm(xq.contiguous(), wq.t().contiguous().t())
    int8_matmul.calls += 1
    return acc[:M, :N]


int8_matmul.calls = 0  # products launched (a count, as the kernels' ``launches``)


def dynamic_int8_dense(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ kernel + bias`` with both operands dynamically quantized to int8.

    ``x``: ``[..., K]`` activations (per-row scales over the last dim);
    ``kernel``: ``[K, N]`` shared (per-column scales), or ``[C, K, N]`` per
    coalition with ``x`` of shape ``[C, ..., K]``; ``bias``: ``[N]`` or
    ``[C, N]``. The result is rescaled in float32 and cast to ``out_dtype``
    (``x``'s dtype by default)."""
    K = x.shape[-1]
    xq, sx = quantize_symmetric(x, dim=-1)            # [..., K] int8, [..., 1]
    if kernel.dim() == 2:
        wq, sw = quantize_symmetric(kernel, dim=0)    # [K, N] int8, [1, N]
        acc = int8_matmul(xq.reshape(-1, K), wq).reshape(*x.shape[:-1], -1)
        sw = sw.reshape((1,) * (x.dim() - 1) + (-1,))
    else:
        C = kernel.shape[0]
        if x.shape[0] != C:
            raise ValueError(f"per-coalition kernel of {C} coalitions for x of shape {tuple(x.shape)}")
        wq, sw = quantize_symmetric(kernel, dim=1)    # [C, K, N] int8, [C, 1, N]
        acc = torch.stack([
            int8_matmul(xq[c].reshape(-1, K), wq[c]).reshape(*x.shape[1:-1], -1)
            for c in range(C)
        ])
        sw = sw.reshape((C,) + (1,) * (x.dim() - 2) + (-1,))
    y = acc.float() * sx * sw
    if bias is not None:
        b = bias.float()
        if b.dim() == 2:  # per-coalition bias [C, N]
            b = b.reshape((b.shape[0],) + (1,) * (x.dim() - 2) + (-1,))
        y = y + b
    return y.to(out_dtype or x.dtype)
