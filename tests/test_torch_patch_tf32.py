"""The float32 patch-embedding route's arithmetic (3xTF32), emulated on the CPU.

On the card the ``"tf32x3"`` route of ``ops/patch_embed.py``
(``patch_embed_tf32x3_kernel`` in ``csrc/patch_embed.cu``) computes
out = patches · W + bias over the [B·N, P·P·C] patch matrix:

* W split into its TF32 pair, hi = tf32(w) and lo = tf32(w - hi)
  (``cvt.rna``), with K zero-padded to a multiple of 4; each patch value
  split the same way in registers;
* each chunk of 32 k taken as the 3xTF32 products A_lo·W_hi + A_hi·W_lo +
  A_hi·W_hi into a fresh accumulator, which is added to a float32 sum;
* the float32 bias added to the sum.

A product of two TF32 values is exact in float32, so numpy's float32
products of the parts emulate the tensor cores up to the order of the
float32 sums. These tests hold that emulation, at the round's patch shape
(224 px, P 16, C 3, D 768) on numpy-seeded inputs, against a float64
reference (within 1e-5 of the largest output, where one TF32 product is
not) and against the JAX Pallas kernel run by the interpreter (within
2e-5), also at the narrow shapes the card tests give the kernel (K = 75
and 25, under one chunk; D = 33 and 100).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp_tf32 import split, tf32_rna

from shapley_vit_tpu.ops.patch_embed import patch_embed as j_patch_embed
from shapley_vit_tpu_torch.ops import patch_embed as tpe
from torch_one_thread import one_torch_thread  # noqa: F401

CHUNK = 32  # k per stage of the kernel


def inputs(B: int, H: int, P: int, C: int, D: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, H, C)).astype(np.float32)
    w = (rng.normal(size=(P * P * C, D)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return img, w, b


def patches(img: np.ndarray, P: int) -> np.ndarray:
    """[B·N, P·P·C] in HF (ph, pw, C) order over a row-major grid."""
    x = tpe.patchify(torch.from_numpy(img), P).numpy()
    return x.reshape(-1, x.shape[-1])


def chunked(x: np.ndarray, w: np.ndarray, product) -> np.ndarray:
    """The kernel's sum: K padded to a multiple of 4 with zeros, each chunk
    of 32 k by ``product`` into its own float32 result, added to a float32
    sum in order."""
    K = x.shape[1]
    kpad = -(-K // 4) * 4
    x = np.pad(x, ((0, 0), (0, kpad - K)))
    w = np.pad(w, ((0, kpad - K), (0, 0)))
    total = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, kpad, CHUNK):
        total += product(x[:, k0:k0 + CHUNK], w[k0:k0 + CHUNK])
    return total


def product_3xtf32(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh  # float32 products and sums


def product_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


def emulated(img, w, b, P: int, product=product_3xtf32) -> np.ndarray:
    B, H, W, _ = img.shape
    out = chunked(patches(img, P), w, product) + b
    return out.reshape(B, (H // P) * (W // P), w.shape[1])


def reference64(img, w, b, P: int) -> np.ndarray:
    B, H, W, _ = img.shape
    out = patches(img, P).astype(np.float64) @ w.astype(np.float64) + b.astype(np.float64)
    return out.reshape(B, (H // P) * (W // P), w.shape[1])


def test_3xtf32_patch_embedding_within_1e5_of_float64():
    """At the round's shape (K = 768, 24 chunks) the 3xTF32 sum is within
    1e-5 of float64, relative to the largest output; one TF32 product per
    term is not."""
    img, w, b = inputs(2, 224, 16, 3, 768)
    want = reference64(img, w, b, 16)
    scale = np.abs(want).max()
    err = np.abs(emulated(img, w, b, 16) - want).max() / scale
    err_tf32 = np.abs(emulated(img, w, b, 16, product_tf32) - want).max() / scale
    assert err <= 1e-5, err
    assert err_tf32 > 1e-5, err_tf32


@pytest.mark.parametrize("B,H,P,C,D", [(2, 224, 16, 3, 768), (2, 15, 5, 3, 64),
                                       (2, 30, 5, 1, 33), (2, 48, 8, 3, 100)])
def test_3xtf32_patch_embedding_matches_jax(B, H, P, C, D):
    """The emulated route against the JAX Pallas kernel (interpreted) on the
    same inputs, within 2e-5: the round's shape, and K = 75 and 25 (padded
    to 76 and 28, one partial chunk), D = 33 and 100 (part of a 128-column
    tile)."""
    img, w, b = inputs(B, H, P, C, D, seed=1)
    want = np.asarray(j_patch_embed(jnp.asarray(img), jnp.asarray(w), jnp.asarray(b), P,
                                    interpret=True))
    got = emulated(img, w, b, P)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
