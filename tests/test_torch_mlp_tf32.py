"""The float32 MLP route's arithmetic (3xTF32), emulated on the CPU.

On the card the ``"tf32x3"`` route of ``ops/mlp_block.py`` splits every
float32 operand a of its two products into a TF32 pair, hi = tf32(a) and
lo = tf32(a - hi) (``cvt.rna``: 10 mantissa bits, to nearest with ties away
from zero), and takes each product as A_lo·B_hi + A_hi·B_lo + A_hi·B_hi in
float32 accumulators. A product of two TF32 values is exact in float32, so
numpy's float32 products of the parts emulate the tensor cores up to the
order of the float32 sums. These tests hold that emulation, at the MLP
block's ViT-B widths (D 768, hidden 3072) on numpy-seeded inputs, against a
float64 reference: within 1e-5, where one TF32 product is not.
"""

import numpy as np
import pytest
import torch

from shapley_vit_tpu_torch.ops import mlp_block as tmlp

D, HD, M = 768, 3072, 64


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32, to nearest with ties away from zero: add half
    of the 13 dropped bits to the magnitude, then clear them."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a: np.ndarray):
    hi = tf32_rna(a)
    return hi, tf32_rna(np.asarray(a, np.float32) - hi)


def product_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh  # float32 products and sums


def product_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return tf32_rna(a) @ tf32_rna(b)


def gelu64(h: np.ndarray) -> np.ndarray:
    return torch.nn.functional.gelu(torch.from_numpy(h)).numpy()


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def randn(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(x=randn((M, D)), ls=1 + randn((D,), 0.1), lb=randn((D,), 0.1),
                w1=randn((D, HD), 0.03), b1=randn((HD,), 0.1), w2=randn((HD, D), 0.03),
                b2=randn((D,), 0.1))


def layer_norm(x, ls, lb, dtype):
    x = x.astype(dtype)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return ((x - mean) / np.sqrt(var + 1e-12) * ls + lb).astype(dtype)


def mlp_block(t: dict, product) -> np.ndarray:
    """The block as the route computes it: float32 LN, ``product`` for fc1
    and fc2, float32 bias, GELU and residual."""
    y = layer_norm(t["x"], t["ls"], t["lb"], np.float32)
    h = gelu64((product(y, t["w1"]) + t["b1"]).astype(np.float64)).astype(np.float32)
    return t["x"] + (product(h, t["w2"]) + t["b2"])


def mlp_block64(t: dict) -> np.ndarray:
    t64 = {k: v.astype(np.float64) for k, v in t.items()}
    y = layer_norm(t64["x"], t64["ls"], t64["lb"], np.float64)
    h = gelu64(y @ t64["w1"] + t64["b1"])
    return t64["x"] + (h @ t64["w2"] + t64["b2"])


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's step at 1
    below, tie, above = (np.float32(one + ulp * f) for f in (0.25, 0.5, 0.75))
    np.testing.assert_array_equal(tf32_rna(np.array([below, tie, above, -tie])),
                                  np.array([one, one + ulp, one + ulp, -(one + ulp)], np.float32))
    hi = tf32_rna(np.float32(np.pi))
    assert hi.view(np.uint32) & 0x1FFF == 0 and abs(hi - np.pi) <= 2.0 ** -11 * np.pi


@pytest.mark.parametrize("which", ["fc1", "fc2"])
def test_3xtf32_products_keep_float32_accuracy(which):
    """Each of the block's two products at its ViT-B shape: 3xTF32 within
    1e-5 of float64 (relative to the output's scale), one TF32 product
    more than ten times that far."""
    t = inputs(1)
    if which == "fc1":
        a = layer_norm(t["x"], t["ls"], t["lb"], np.float32)
        b = t["w1"]
    else:
        a = np.abs(np.random.default_rng(2).normal(size=(M, HD))).astype(np.float32) * 0.5
        b = t["w2"]
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(want).max()
    err3 = np.abs(product_3xtf32(a, b) - want).max() / scale
    err1 = np.abs(product_tf32(a, b) - want).max() / scale
    assert err3 <= 1e-5, err3
    assert err1 > 10 * 1e-5, err1


def test_3xtf32_mlp_block_within_1e5_of_float64():
    """The whole block at D 768, hidden 3072: the emulated route within 1e-5
    of float64 and of the port's plain version (what the route is held
    against on the card), a single-TF32 block not."""
    t = inputs(0)
    want = mlp_block64(t)
    got = mlp_block(t, product_3xtf32)
    one = mlp_block(t, product_tf32)
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(one - want).max() > 1e-5
    plain = tmlp.fused_mlp_block_plain(*(torch.from_numpy(t[k]) for k in
                                         ("x", "ls", "lb", "w1", "b1", "w2", "b2")), eps=1e-12)
    assert np.abs(plain.numpy() - got).max() <= 1e-5
