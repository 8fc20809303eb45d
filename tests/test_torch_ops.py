"""The port's plain kernel versions against the JAX package's Pallas kernels.

Each plain version (``shapley_vit_tpu_torch.ops``) is what a wrapper runs for
a CPU tensor, and what ``chip_smoke.py`` holds the CUDA kernel against. Here
it is held, at float32, against the JAX kernel run by the Pallas interpreter
and against the JAX package's XLA math (``_xla_attention``, ``_patchify @ W``):
atol 2e-5 / rtol 1e-4 (1e-5 for the patch embedding, a single product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models.vit import _patchify
from shapley_vit_tpu.ops import attention as jatt
from shapley_vit_tpu.ops.mlp_block import fused_mlp_block as j_mlp
from shapley_vit_tpu.ops.patch_embed import patch_embed as j_patch
from shapley_vit_tpu_torch.ops import attention as tatt
from shapley_vit_tpu_torch.ops import mlp_block as tmlp
from shapley_vit_tpu_torch.ops import patch_embed as tpe
from torch_one_thread import one_torch_thread  # noqa: F401


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("B,HW,P,D", [(2, 16, 4, 32), (3, 24, 8, 20)])
def test_patch_embed_plain_matches_pallas_and_patchify(B, HW, P, D):
    rng = np.random.default_rng(0)
    img, w, b = _np(rng, (B, HW, HW, 3)), _np(rng, (P * P * 3, D), 0.1), _np(rng, (D,), 0.1)
    before = tpe.patch_embed.launches
    got = tpe.patch_embed(torch.tensor(img), torch.tensor(w), torch.tensor(b), P).numpy()
    assert tpe.patch_embed.launches == before  # a CPU tensor never launches the kernel
    pallas = np.asarray(j_patch(jnp.asarray(img), jnp.asarray(w), jnp.asarray(b), P, interpret=True))
    xla = np.asarray(_patchify(jnp.asarray(img), P) @ w + b)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tpe.patchify(torch.tensor(img), P).numpy(), np.asarray(_patchify(jnp.asarray(img), P))
    )


@pytest.mark.parametrize("N", [197, 100, 64])
def test_attention_plain_matches_pallas_and_xla(N):
    B, H, d = 2, 4, 16
    rng = np.random.default_rng(1)
    q, k, v = (_np(rng, (B, N, H * d)) for _ in range(3))
    before = tatt.fused_attention_packed.launches
    got = tatt.fused_attention_packed(torch.tensor(q), torch.tensor(k), torch.tensor(v), heads=H)
    assert tatt.fused_attention_packed.launches == before
    got = got.numpy()
    pallas = np.asarray(jatt.fused_attention_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=H, interpret=True))

    def heads(t):
        return jnp.asarray(t).reshape(B, N, H, d).transpose(0, 2, 1, 3)

    xla = np.asarray(jatt._xla_attention(heads(q), heads(k), heads(v)))
    xla = xla.transpose(0, 2, 1, 3).reshape(B, N, H * d)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("M", [100, 64, 33])
def test_mlp_plain_matches_pallas_and_reference_math(M, approximate):
    D, Hd = 64, 256
    rng = np.random.default_rng(2)
    x = _np(rng, (M, D))
    ls, lb = 1 + _np(rng, (D,), 0.1), _np(rng, (D,), 0.1)
    w1, b1 = _np(rng, (D, Hd), 0.05), _np(rng, (Hd,), 0.1)
    w2, b2 = _np(rng, (Hd, D), 0.05), _np(rng, (D,), 0.1)
    args = (x, ls, lb, w1, b1, w2, b2)
    before = tmlp.fused_mlp_block.launches
    got = tmlp.fused_mlp_block(*map(torch.tensor, args), eps=1e-12,
                               approximate_gelu=approximate).numpy()
    assert tmlp.fused_mlp_block.launches == before
    pallas = np.asarray(j_mlp(*map(jnp.asarray, args), eps=1e-12, block_rows=64,
                              interpret=True, approximate_gelu=approximate))
    import jax

    xf = jnp.asarray(x)
    y = (xf - xf.mean(-1, keepdims=True)) * jax.lax.rsqrt(xf.var(-1, keepdims=True) + 1e-12) * ls + lb
    ref = np.asarray(xf + jax.nn.gelu(y @ w1 + b1, approximate=approximate) @ w2 + b2)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_plain_versions_keep_bf16_in_and_out():
    """bf16 inputs give bf16 outputs, with the kernels' f32 arithmetic inside:
    the plain version equals itself run on the bf16-rounded values in f32
    (then rounded to bf16)."""
    rng = np.random.default_rng(3)
    q = torch.tensor(_np(rng, (2, 17, 32))).bfloat16()
    out = tatt.fused_attention_packed(q, q, q, heads=2)
    assert out.dtype == torch.bfloat16
    ref = tatt.fused_attention_packed(q.float(), q.float(), q.float(), heads=2).bfloat16()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    x = torch.tensor(_np(rng, (5, 16))).bfloat16()
    w1 = torch.tensor(_np(rng, (16, 32), 0.1)).bfloat16()
    w2 = torch.tensor(_np(rng, (32, 16), 0.1)).bfloat16()
    ones, zeros = torch.ones(16).bfloat16(), torch.zeros(16).bfloat16()
    y = tmlp.fused_mlp_block(x, ones, zeros, w1, torch.zeros(32).bfloat16(), w2, zeros)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
