"""The float32 attention route's arithmetic (3xTF32, key blocks, an online
softmax), emulated on the CPU.

On the card the ``"tf32x3"`` route of ``ops/attention.py``
(``attention_tf32x3_kernel`` in ``csrc/attention.cu``) computes, per (image,
head), o = softmax(q kᵀ / √d) v over blocks of keys (64 keys at head dim
64, 32 at head dim 128):

* each block's scores s = q kᵀ as 3xTF32 products, q_lo k_hi + q_hi k_lo +
  q_hi k_hi, with hi = tf32(a) and lo = tf32(a - hi) (``cvt.rna``);
* the online softmax: keys at or past N to -inf, the running row max m of
  the scores times scale·log2 e, p = 2^(s·scale·log2 e - m), the running sum
  l and the output rescaled by 2^(m_old - m_new) when the max moves;
* the block's p v as 3xTF32 products into a fresh float32 accumulator, added
  to the output; the output divided by l at the end.

A product of two TF32 values is exact in float32, so numpy's float32 products
of the parts emulate the tensor cores up to the order of the float32 sums.
These tests hold that emulation against a float64 reference at N = 197 (224
px), 257 (256 px) and 577 (384 px) and head dims 64 and 128, on numpy-seeded
inputs: within 1e-5, where one TF32 product per score and output is not; and
the key-blocked online softmax alone (float32 products) within 1e-6 of the
port's plain version, which the card holds the route against.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_mlp_tf32 import split, tf32_rna

from shapley_vit_tpu_torch.ops import attention as tatt

LOG2E = np.float32(1.4426950408889634)
SHAPES = [(197, 64), (257, 64), (577, 64), (197, 128), (577, 128)]


def block_keys(d: int) -> int:
    """Keys per block of the kernel at head dim d."""
    return 64 if d == 64 else 32


def product_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh  # float32 products and sums


def product_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def product_f32(a, b):
    return a @ b


def blocked_attention(q, k, v, product, bk: int) -> np.ndarray:
    """One head, q/k/v [N, d] float32: the kernel's key loop with an online
    softmax, each block's products by ``product``."""
    n, d = q.shape
    l2 = np.float32(1.0 / math.sqrt(d)) * LOG2E
    m = np.full((n, 1), -np.inf, np.float32)
    l = np.zeros((n, 1), np.float32)
    o = np.zeros((n, d), np.float32)
    for k0 in range(0, n, bk):
        kb, vb = k[k0:k0 + bk], v[k0:k0 + bk]  # the last block: the keys below N
        s = product(q, kb.T)
        m_new = np.maximum(m, s.max(axis=1, keepdims=True) * l2)
        alpha = np.exp2(m - m_new)
        p = np.exp2(s * l2 - m_new).astype(np.float32)
        l = l * alpha + p.sum(axis=1, keepdims=True)
        o = o * alpha + product(p, vb)
        m = m_new
    return (o / l).astype(np.float32)


def attention64(q, k, v) -> np.ndarray:
    q, k, v = (t.astype(np.float64) for t in (q, k, v))
    s = q @ k.T / math.sqrt(q.shape[1])
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v


def inputs(n: int, d: int, heads: int = 2):
    """q, k, v [heads, N, d], standard normal as the card checks draw them."""
    rng = np.random.default_rng(n + d)
    return [rng.normal(size=(heads, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_3xtf32_online_softmax_within_1e5_of_float64(n, d):
    q, k, v = inputs(n, d)
    for h in range(q.shape[0]):
        want = attention64(q[h], k[h], v[h])
        got = blocked_attention(q[h], k[h], v[h], product_3xtf32, block_keys(d))
        assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("n,d", SHAPES)
def test_single_tf32_products_miss_1e5(n, d):
    """The same loop with one TF32 product per score and per output term:
    the 1e-5 bar is one that only the split meets."""
    q, k, v = inputs(n, d)
    want = attention64(q[0], k[0], v[0])
    got = blocked_attention(q[0], k[0], v[0], product_tf32, block_keys(d))
    assert np.abs(got - want).max() > 1e-5


@pytest.mark.parametrize("n,d", SHAPES)
def test_key_blocked_online_softmax_matches_the_plain_version(n, d):
    """With float32 products the key blocks and the online softmax change
    nothing past float32 rounding: within 1e-6 of
    ``fused_attention_packed_plain`` (whole rows, exp, one division)."""
    q, k, v = inputs(n, d)
    H = q.shape[0]
    got = np.stack([blocked_attention(q[h], k[h], v[h], product_f32, block_keys(d))
                    for h in range(H)])  # [H, N, d]
    packed = [torch.from_numpy(np.ascontiguousarray(t.transpose(1, 0, 2).reshape(1, n, H * d)))
              for t in (q, k, v)]
    plain = tatt.fused_attention_packed_plain(*packed, heads=H).numpy()
    plain = plain.reshape(n, H, d).transpose(1, 0, 2)
    assert np.abs(got - plain).max() <= 1e-6
