"""The bf16 key-loop attention route's arithmetic, emulated on the CPU.

On the card the ``"wgmma_kl"`` route of ``ops/attention.py``
(``attention_wgmma_kl_kernel`` in ``csrc/attention.cu``: bf16 past 224 keys
or at head dim 128) computes, per (image, head), o = softmax(q kᵀ / √d) v
over blocks of 64 keys:

* each block's scores s = q kᵀ on the tensor cores: bf16 products, exact in
  float32, summed in float32;
* the online softmax: the running row max m of the scores times
  scale·log2 e, p = 2^(s·scale·log2 e - m), the running sum l and the output
  rescaled by 2^(m_old - m_new) when the max moves;
* p v as p_hi v + p_lo v (p_hi = bf16(p), p_lo = bf16(p - p_hi)) into the
  float32 output, which is divided by l at the end and rounded to bf16.

These tests hold that emulation, in float32 torch ops on numpy-seeded bf16
inputs at N = 197, 257 (256 px) and 577 (384 px) and head dims 64 and 128,
against the port's plain version (float32 softmax and products, output
rounded to bf16) within the bound that the card test
``test_attention_bf16_error_at_the_round_shape`` holds the main paths'
kernel to: 2^-17 Σ p|v| plus one bf16 step of the larger output. The split
keeps 16 bits of p, so the key loop moves the outputs no further from the
plain version than the main paths' kernel, which takes all keys in one
pass; rounding p to bf16 alone breaks the bound.
"""

import math

import numpy as np
import pytest
import torch

from shapley_vit_tpu_torch.ops import attention as tatt
from torch_one_thread import one_torch_thread  # noqa: F401

LOG2E = 1.4426950408889634
SHAPES = [(197, 64), (257, 64), (577, 64), (197, 128), (577, 128)]


def bf16(t):
    return t.to(torch.bfloat16).float()


def key_loop(q, k, v, split: bool = True, bk: int = 64) -> torch.Tensor:
    """One head, q/k/v [N, d] bf16 values in float32: the kernel's key loop
    with an online softmax; p v with p split in two bf16 parts, or with p
    rounded to bf16 (``split=False``). Returns the bf16 output as float32."""
    n, d = q.shape
    l2 = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=torch.float32)
    m = torch.full((n, 1), -math.inf)
    l = torch.zeros((n, 1))
    o = torch.zeros((n, d))
    for k0 in range(0, n, bk):
        kb, vb = k[k0:k0 + bk], v[k0:k0 + bk]  # the last block: the keys below N
        s = q @ kb.T
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True) * l2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * l2 - m_new)
        l = l * alpha + p.sum(dim=1, keepdim=True)
        hi = bf16(p)
        pv = hi @ vb + (bf16(p - hi) @ vb if split else 0.0)
        o = o * alpha + pv
        m = m_new
    return bf16(o / l)


def inputs(n: int, d: int, heads: int = 2):
    """q, k, v [heads, N, d], standard normal rounded to bf16, as the card
    checks draw them."""
    rng = np.random.default_rng(n + d)
    return [bf16(torch.as_tensor(rng.normal(size=(heads, n, d)), dtype=torch.float32))
            for _ in range(3)]


def plain_and_weight(q, k, v):
    """The plain version's bf16 output and Σ p|v| (float32), [heads, N, d]."""
    H, n, d = q.shape
    packed = [t.transpose(0, 1).reshape(1, n, H * d).to(torch.bfloat16) for t in (q, k, v)]
    plain = tatt.fused_attention_packed_plain(*packed, heads=H).float()
    plain = plain.reshape(n, H, d).transpose(0, 1)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    return plain, p @ v.abs()


def excess(got, want, weight):
    """How far each output lies past 2^-17 Σ p|v| plus one bf16 step of the
    larger of the two outputs."""
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)  # bf16: 8 significant bits
    return (got - want).abs() - (2.0 ** -17 * weight + step)


@pytest.mark.parametrize("n,d", SHAPES)
def test_key_loop_with_the_split_within_the_main_kernels_bound(n, d):
    q, k, v = inputs(n, d)
    want, weight = plain_and_weight(q, k, v)
    got = torch.stack([key_loop(q[h], k[h], v[h]) for h in range(q.shape[0])])
    assert excess(got, want, weight).max().item() <= 0


@pytest.mark.parametrize("n,d", SHAPES)
def test_key_loop_with_p_rounded_to_bf16_misses_it(n, d):
    """The same loop with p rounded to bf16 alone (2^-9 p): the bound is one
    that only the split meets."""
    q, k, v = inputs(n, d)
    want, weight = plain_and_weight(q, k, v)
    got = torch.stack([key_loop(q[h], k[h], v[h], split=False) for h in range(q.shape[0])])
    assert excess(got, want, weight).max().item() > 0
