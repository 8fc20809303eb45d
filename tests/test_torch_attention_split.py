"""The precision decision of the bf16 attention kernel (``csrc/attention.cu``).

On the card the kernel computes p v on the tensor cores, whose inputs are
bf16, while the Pallas kernel multiplies p v in float32. The kernel splits
p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi), and runs two bf16
products into one float32 accumulator. These tests hold that arithmetic, in
float32 torch ops on the CPU, against p v in float32: the split stays within
1e-5 of it (about 3e-6 here), far below the bf16 rounding of the output
(2^-9), while p rounded to bf16 alone is off by more than 1e-4 (about 2e-3).
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401

N, D, ROWS = 197, 64, 256


def _probabilities_and_v(seed):
    """float32 softmax probabilities [ROWS, N] of bf16 q k^T / 8 (the ViT's
    head dim 64) and bf16 v [N, D], from a numpy seed."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).to(torch.bfloat16)

    q, k, v = bf16((ROWS, D)), bf16((N, D)), bf16((N, D))
    p = torch.softmax((q.float() @ k.float().T) / 8.0, dim=-1)
    return p, v


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _bf16_product(p16, v):
    """p v with bf16 inputs and float32 products and sums, as the tensor
    cores take them: both inputs are bf16 values, exact in float32."""
    return p16.float() @ v.float()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_lo_split_keeps_float32_pv(seed):
    p, v = _probabilities_and_v(seed)
    want = p @ v.float()
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    # p_hi + p_lo carries 16 bits of p (8 each): |p - p_hi - p_lo| <= 2^-16 p
    assert ((p - hi.float() - lo.float()).abs() <= 2.0 ** -16 * p).all()
    got = _bf16_product(hi, v) + _bf16_product(lo, v)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_p_alone_is_visibly_worse(seed):
    p, v = _probabilities_and_v(seed)
    want = p @ v.float()
    assert _rel_err(_bf16_product(p.to(torch.bfloat16), v), want) > 1e-4
