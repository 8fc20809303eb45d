"""The port's Hopper kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper GPU and ``nvcc`` (the kernels are built at
first use); on a machine without a card they skip. Run them there with

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX, which the port and this
file do not use.) Tolerances: float32 atol/rtol 1e-4 (sums over up to 4096
terms taken in another order); bfloat16 2e-2 (outputs are rounded to bf16,
2^-8 relative, and intermediates the kernels round to bf16 may land on the
neighbouring value).
"""

import numpy as np
import pytest
import torch

from shapley_vit_tpu_torch.ops import attention as att
from shapley_vit_tpu_torch.ops import mlp_block as mlp
from shapley_vit_tpu_torch.ops import patch_embed as pe

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ for sm_90a)")


def _randn(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32).to(
        "cuda", dtype
    )


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,C,D", [(3, 224, 16, 3, 768), (2, 48, 8, 3, 100)])
def test_patch_embed_kernel_matches_plain(dtype, B, H, P, C, D):
    rng = np.random.default_rng(0)
    img = _randn(rng, (B, H, H, C), dtype=dtype)
    w = _randn(rng, (P * P * C, D), 0.05, dtype)
    b = _randn(rng, (D,), 0.1, dtype)
    before = pe.patch_embed.launches
    got = pe.patch_embed(img, w, b, P)
    torch.cuda.synchronize()
    assert pe.patch_embed.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, (H // P) ** 2, D)
    _close(got, pe.patch_embed_plain(img, w, b, P), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,H", [(3, 197, 12), (2, 100, 4), (2, 64, 2), (1, 224, 1)])
def test_attention_kernel_matches_plain(dtype, B, N, H):
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (B, N, H * 64), dtype=dtype) for _ in range(3))
    before = att.fused_attention_packed.launches
    got = att.fused_attention_packed(q, k, v, heads=H)
    torch.cuda.synchronize()
    assert att.fused_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("M,D,Hd", [(591, 768, 3072), (100, 384, 1536), (33, 1024, 4096), (70, 768, 3000)])
def test_mlp_kernel_matches_plain(dtype, approximate, M, D, Hd):
    rng = np.random.default_rng(2)
    x = _randn(rng, (M, D), dtype=dtype)
    ls = (1 + _randn(rng, (D,), 0.1)).to(dtype)
    lb = _randn(rng, (D,), 0.1, dtype)
    w1 = _randn(rng, (D, Hd), 0.03, dtype)
    b1 = _randn(rng, (Hd,), 0.1, dtype)
    w2 = _randn(rng, (Hd, D), 0.03, dtype)
    b2 = _randn(rng, (D,), 0.1, dtype)
    before = mlp.fused_mlp_block.launches
    got = mlp.fused_mlp_block(x, ls, lb, w1, b1, w2, b2, eps=1e-12, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = mlp.fused_mlp_block_plain(x, ls, lb, w1, b1, w2, b2, eps=1e-12,
                                     approximate_gelu=approximate)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,N", [(64, 12, 197), (3, 4, 100), (2, 2, 17), (1, 1, 224)])
@pytest.mark.parametrize("layout", ["split_heads", "contiguous"])
def test_bhnd_attention_kernel_matches_plain(dtype, B, H, N, layout):
    """[B, H, N, d] attention: on the views a head split makes of packed
    projections (read in place) and on contiguous tensors."""
    rng = np.random.default_rng(5)
    packed = [_randn(rng, (B, N, H * 64), dtype=dtype) for _ in range(3)]
    q, k, v = (t.view(B, N, H, 64).transpose(1, 2) for t in packed)
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = att.fused_attention.launches
    got = att.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert att.fused_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, N, 64) and got.stride() == q.stride()
    _close(got, att.fused_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bhnd_attention_gradient_on_the_card(dtype):
    """The Function's gradient (kernel forward, recomputed backward) against
    autograd through the plain version, and the backward launches nothing."""
    rng = np.random.default_rng(6)
    B, H, N = 4, 12, 197
    base = [_randn(rng, (B, N, H * 64), dtype=dtype) for _ in range(3)]
    cot = _randn(rng, (B, H, N, 64), dtype=dtype)
    grads = []
    for fn in (att.fused_attention, att.fused_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        views = [t.view(B, N, H, 64).transpose(1, 2) for t in leaves]
        out = fn(*views)
        before = att.fused_attention.launches
        out.backward(cot)
        assert att.fused_attention.launches == before
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close(a, b, dtype)


def test_bhnd_attention_odd_layouts_are_copied_first():
    """q/k/v with different strides, or a bf16 view that is not 16-byte
    aligned, still give the plain version's result."""
    rng = np.random.default_rng(7)
    B, H, N = 2, 3, 60
    q = _randn(rng, (B, H, N, 64))
    k = _randn(rng, (B, N, H, 64)).transpose(1, 2)
    v = _randn(rng, (B, H, 64, N)).transpose(2, 3)
    _close(att.fused_attention(q, k, v), att.fused_attention_plain(q, k, v), torch.float32)
    buf = _randn(rng, (3 * B * H * N * 64 + 1,), dtype=torch.bfloat16)
    q, k, v = (buf[1 + i * B * H * N * 64:1 + (i + 1) * B * H * N * 64].view(B, H, N, 64)
               for i in range(3))
    assert q.data_ptr() % 16
    _close(att.fused_attention(q, k, v), att.fused_attention_plain(q, k, v), torch.bfloat16)


def test_attention_bf16_unaligned_tensors_take_the_fma_path():
    """bf16 tensors that are not 16-byte aligned skip the tensor-core path
    (16-byte vector loads) for the FMA one; both match the plain version."""
    rng = np.random.default_rng(4)
    B, N, H = 2, 197, 12

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v = (unaligned(_randn(rng, (B, N, H * 64), dtype=torch.bfloat16)) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    got = att.fused_attention_packed(q, k, v, heads=H)
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), torch.bfloat16)


def test_kernels_reject_what_they_do_not_take():
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 10, 4 * 32))  # head dim 32
    with pytest.raises(ValueError):
        att.fused_attention_packed(q, q, q, heads=4)
    qh = q.view(2, 10, 4, 32).transpose(1, 2)
    with pytest.raises(ValueError, match="head dim"):
        att.fused_attention(qh, qh, qh)
    long = _randn(rng, (1, 1, 300, 64))
    with pytest.raises(ValueError, match="sequence length"):
        att.fused_attention(long, long, long)
    x = _randn(rng, (4, 64))
    w = _randn(rng, (64, 128))
    with pytest.raises(ValueError):
        mlp.fused_mlp_block(x, x[0], x[0], w, w[0], w.T.contiguous(), x[0])
    img = _randn(rng, (1, 32, 32, 3)).half()
    with pytest.raises(TypeError):
        pe.patch_embed(img, _randn(rng, (48, 16)).half(), _randn(rng, (16,)).half(), 4)


@pytest.mark.parametrize("remat", [False, True])
def test_training_step_on_the_card_matches_the_cpu(remat):
    """A float32 training step of a small ViT with head dim 64 through the
    training spec: the card (kernels) against the CPU (plain versions), and
    the attention kernel launched once per block, twice under remat."""
    from shapley_vit_tpu_torch.fl import training as tr
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.ops import tree_math as tm

    spec = tvit.make_spec("micro", hidden=128, heads=2, mlp_dim=256, attention_impl="pallas",
                          mlp_impl="xla", remat=remat)
    gen = torch.Generator().manual_seed(0)
    base = tvit.init_vit(gen, spec)
    lora = tm.tree_map(lambda a: a + 0.05 * torch.randn(a.shape, generator=gen),
                       tvit.init_lora(gen, spec, classifier_from=base))
    images = torch.rand((4, spec.image, spec.image, 3), generator=gen)
    labels = torch.tensor([0, 1, 2, 3])
    out = {}
    for dev in ("cpu", "cuda"):
        lo = tr.trainable(tm.tree_map(lambda a: a.to(dev), lora))
        before = att.fused_attention.launches
        loss = tr.cross_entropy(tvit.vit_forward(tm.tree_map(lambda a: a.to(dev), base), lo,
                                                 images.to(dev), spec), labels.to(dev))
        loss.backward()
        out[dev] = (float(loss.detach()), [t.grad.cpu() for t in tm.tree_leaves(lo)],
                    att.fused_attention.launches - before)
    assert out["cpu"][2] == 0 and out["cuda"][2] == spec.depth * (2 if remat else 1)
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-5
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
