"""The port's ``fused_attention`` ([B, H, N, d], with a gradient) against the
JAX package's ``_attn_kernel``, at float32 on the CPU.

The forward is held against the Pallas kernel under the interpreter
(``_fused_attention_fwd_impl(interpret=True)``) and against
``_xla_attention``; the gradient against ``jax.grad`` through the JAX
``fused_attention`` with its Pallas path on (``SVT_PALLAS_INTERPRET=1``),
whose VJP recomputes with XLA math as the port's backward does with torch
ops. Tolerances: atol 2e-5 (rtol 1e-4 on the forward), float32 sums over at
most 197 keys taken in another order.

Also here: the forward-only kernels refuse a call that autograd would need
a gradient through, instead of cutting the graph; ``patch_embed``'s
gradient (torch ops) against autograd and ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.ops import attention as jatt
from shapley_vit_tpu_torch.ops import attention as tatt
from shapley_vit_tpu_torch.ops import mlp_block as tmlp
from shapley_vit_tpu_torch.ops import patch_embed as tpe

SEQ_LENS = [197, 128, 100, 17]


def _qkv(N, B=2, H=3, d=64, seed=0):
    rng = np.random.default_rng(seed + N)
    return [rng.normal(size=(B, H, N, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("N", SEQ_LENS)
def test_forward_matches_pallas_kernel_and_xla(N):
    q, k, v = _qkv(N)
    pallas = np.asarray(jatt._fused_attention_fwd_impl(q, k, v, interpret=True))
    xla = np.asarray(jatt._xla_attention(q, k, v))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    plain = tatt.fused_attention_plain(tq, tk, tv).numpy()
    launches = tatt.fused_attention.launches
    got = tatt.fused_attention(tq, tk, tv)
    assert tatt.fused_attention.launches == launches  # a CPU tensor runs the plain version
    assert got.shape == (2, 3, N, 64) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), plain)
    for want in (pallas, xla):
        np.testing.assert_allclose(plain, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tatt.xla_attention(tq, tk, tv).numpy(), xla, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("N", SEQ_LENS)
def test_gradient_matches_jax_vjp(N, monkeypatch):
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    q, k, v = _qkv(N, seed=1)
    w = np.random.default_rng(N).normal(size=q.shape).astype(np.float32)  # the cotangent

    def jloss(q, k, v):
        return jnp.sum(jatt.fused_attention(q, k, v) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (tatt.fused_attention(tq, tk, tv) * torch.tensor(w)).sum().backward()
    for t, g in zip((tq, tk, tv), want):
        assert float(np.abs(np.asarray(g)).max()) > 1e-3
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-5, rtol=0)


def test_split_head_views_match_contiguous_inputs():
    """The ViT hands the op the [B, H, N, d] views that a head split makes of
    packed [B, N, H·d] projections; the result is the same as on contiguous
    copies, and the bfloat16 output stays in bfloat16."""
    rng = np.random.default_rng(3)
    B, N, H, d = 2, 50, 4, 64
    packed = [torch.tensor(rng.normal(size=(B, N, H * d)).astype(np.float32)) for _ in range(3)]
    views = [t.reshape(B, N, H, d).transpose(1, 2) for t in packed]
    assert not views[0].is_contiguous()
    got = tatt.fused_attention(*views)
    want = tatt.fused_attention(*(t.contiguous() for t in views))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the packed op on the same data is the same attention
    np.testing.assert_allclose(got.transpose(1, 2).reshape(B, N, H * d).numpy(),
                               tatt.fused_attention_packed(*packed, heads=H).numpy(),
                               atol=2e-6, rtol=0)
    assert tatt.fused_attention(*(t.bfloat16() for t in views)).dtype == torch.bfloat16


def test_forward_only_kernels_refuse_a_gradient():
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.normal(size=(1, 5, 8)).astype(np.float32))
    leaf = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match='attention_impl="pallas"'):
        tatt.fused_attention_packed(leaf, q, q, heads=2)
    x = torch.tensor(rng.normal(size=(4, 8)).astype(np.float32))
    w1 = torch.tensor(rng.normal(size=(8, 16)).astype(np.float32))
    w2 = torch.tensor(rng.normal(size=(16, 8)).astype(np.float32))
    args = [x, torch.ones(8), torch.zeros(8), w1, torch.zeros(16), w2, torch.zeros(8)]
    for i in range(len(args)):
        bad = list(args)
        bad[i] = bad[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match='mlp_impl="xla"'):
            tmlp.fused_mlp_block(*bad)
        with torch.no_grad():  # no graph to cut: the eval path runs as before
            torch.testing.assert_close(tmlp.fused_mlp_block(*bad), tmlp.fused_mlp_block(*args))
    with torch.no_grad():
        tatt.fused_attention_packed(leaf, q, q, heads=2)


@pytest.mark.parametrize("wrt", ["images", "kernel", "bias"])
def test_patch_embed_gradient_matches_autograd_and_jax(wrt):
    """``patch_embed``'s backward (torch ops) against autograd through
    ``patch_embed_plain``, for each of its three inputs, and the image
    gradient against ``jax.grad`` through the JAX package's ``_patchify`` and
    matmul (the path JAX differentiates): float32, atol 1e-5 (sums over at
    most 48 terms)."""
    from shapley_vit_tpu.models.vit import _patchify as j_patchify

    rng = np.random.default_rng(5)
    img, pw, pb, cot = (rng.normal(size=s).astype(np.float32)
                        for s in ((2, 8, 12, 3), (48, 8), (8,), (2, 6, 8)))
    which = ["images", "kernel", "bias"].index(wrt)

    def grad_of(fn):
        leaves = [torch.tensor(a, requires_grad=i == which) for i, a in enumerate((img, pw, pb))]
        (fn(*leaves, 4) * torch.tensor(cot)).sum().backward()
        return leaves[which].grad.numpy()

    got = grad_of(tpe.patch_embed)
    assert float(np.abs(got).max()) > 1e-3
    np.testing.assert_allclose(got, grad_of(tpe.patch_embed_plain), atol=1e-5, rtol=0)
    if wrt == "images":
        want = jax.grad(lambda x: jnp.sum((j_patchify(x, 4) @ pw + pb) * cot))(jnp.asarray(img))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    # each gradient in its input's dtype
    leaves = [torch.tensor(a).bfloat16().requires_grad_(i == which)
              for i, a in enumerate((img, pw, pb))]
    tpe.patch_embed(*leaves, 4).float().sum().backward()
    assert leaves[which].grad.dtype == torch.bfloat16
