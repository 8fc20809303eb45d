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

import math

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


# The bf16 kernel's routes: W by TMA where D % 8 == 0, else by cp.async
# (D = 100: 8-byte copies; D = 33: 2-byte copies, odd D); patch rows by
# 16-byte copies where P*C % 8 == 0, else narrower (P*C = 12: 8 bytes;
# P*C = 15 or 5: 2 bytes). The float32 kernel's copy widths: 16 bytes
# where P*C % 4 == 0 (48, 24, 12), else 4 bytes (P*C = 15 or 5), and K
# padded to a multiple of 4 (75 -> 76, 25 -> 28) for W's TF32 pair. The
# round's (B = 128) and the training batch's (64) shapes; B*N not a
# multiple of the 128-row tile (3 x 196, 1 x 4); D not a multiple of the
# 128-column tile (100, 200, 33, 64); K = 48, 75 and 25, less than one
# 64-wide (bf16) or 32-wide (float32) k stage.
PATCH_SHAPES = [(3, 224, 16, 3, 768), (2, 48, 8, 3, 100), (128, 224, 16, 3, 768),
                (64, 224, 16, 3, 768), (1, 32, 16, 3, 256), (2, 224, 16, 3, 200),
                (2, 32, 4, 3, 64), (2, 15, 5, 3, 64), (2, 30, 5, 1, 33)]


def _patch_route(dtype):
    """Both dtypes run on the tensor cores: bf16 on wgmma, float32 in 3xTF32."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _patch_inputs(rng, B, H, P, C, D, dtype):
    img = _randn(rng, (B, H, H, C), dtype=dtype)
    w = _randn(rng, (P * P * C, D), 0.05, dtype)
    b = _randn(rng, (D,), 0.1, dtype)
    return img, w, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,C,D", PATCH_SHAPES)
def test_patch_embed_kernel_matches_plain(dtype, B, H, P, C, D):
    rng = np.random.default_rng(0)
    img, w, b = _patch_inputs(rng, B, H, P, C, D, dtype)
    before = pe.patch_embed.launches
    got = pe.patch_embed(img, w, b, P)
    torch.cuda.synchronize()
    assert pe.patch_embed.launches == before + 1
    assert pe.patch_embed.route == _patch_route(dtype)
    assert got.dtype == dtype and got.shape == (B, (H // P) ** 2, D)
    _close(got, pe.patch_embed_plain(img, w, b, P), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,C,D", [(3, 224, 16, 3, 768), (2, 32, 4, 3, 64), (2, 32, 4, 3, 100),
                                       (2, 15, 5, 3, 64)])
def test_patch_embed_reads_nothing_past_the_last_image(dtype, B, H, P, C, D):
    """The images end where a NaN image begins, and W where NaN rows begin:
    a kernel that read a patch row past the last image, a k past K = P*P*C
    (48 < 64 here for P = 4; 75 and 48 past a 32-wide float32 stage) or a
    W row past K would put NaN into its outputs. bf16: W by TMA (D = 768,
    64) and by cp.async (D = 100); float32: W's TF32 pair, K padded to a
    multiple of 4 (75 -> 76), by TMA."""
    rng = np.random.default_rng(9)
    img, w, b = _patch_inputs(rng, B, H, P, C, D, dtype)
    ibuf = torch.full((B + 1, H, H, C), float("nan"), dtype=dtype, device="cuda")
    ibuf[:B] = img
    wbuf = torch.full((P * P * C + 64, D), float("nan"), dtype=dtype, device="cuda")
    wbuf[:P * P * C] = w
    got = pe.patch_embed(ibuf[:B], wbuf[:P * P * C], b, P)
    torch.cuda.synchronize()
    assert pe.patch_embed.route == _patch_route(dtype)
    assert torch.isfinite(got.float()).all()
    _close(got, pe.patch_embed_plain(img, w, b, P), dtype)


def test_patch_embed_tf32x3_entry_refuses_an_unaligned_workspace():
    """The float32 entry's TMA reads W's TF32 pair from the workspace: a
    workspace off 16 bytes (or an output off 8, for its pair stores) gets
    an error and no launch, neither the weight split nor the GEMM."""
    from shapley_vit_tpu_torch.ops import _build

    lib = _build.load("patch_embed", pe._FNS)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(16)
    B, H, P, C, D = 2, 32, 4, 3, 64
    img, w, b = _patch_inputs(rng, B, H, P, C, D, torch.float32)
    K = P * P * C
    for wt_offset, out_offset in ((1, 0), (2, 0), (0, 1)):
        wt = torch.zeros(2 * D * K + 4, device="cuda")
        out = torch.zeros(B * (H // P) ** 2 * D + 1, device="cuda")
        err = lib.svt_patch_embed_tf32x3(img.data_ptr(), w.data_ptr(), b.data_ptr(),
                                         out[out_offset:].data_ptr(), wt[wt_offset:].data_ptr(),
                                         B, H, H, C, P, D, stream)
        torch.cuda.synchronize()
        assert err != 0, (wt_offset, out_offset)
        assert torch.count_nonzero(wt) == 0 and torch.count_nonzero(out) == 0


def test_patch_embed_bf16_within_one_step_at_the_round_shape():
    """At the round's shape every bf16 output is within one bf16 step of the
    plain version's, plus what the two float32 sums may differ by. Both
    round a float32 sum of the same K = 768 products and the bias to bf16;
    the sums are taken in another order, so each is within K u sum|a w| + u
    |bias| of the exact one (u = 2^-24, recursive summation's bound), and
    two float32 values that close round to bf16 values one step of the
    larger apart at most, or that far apart where the sum cancels to near
    zero. A wrong tile, swizzle or k range would miss by O(1)."""
    rng = np.random.default_rng(10)
    K = 16 * 16 * 3
    img, w, b = _patch_inputs(rng, 128, 224, 16, 3, 768, torch.bfloat16)
    got = pe.patch_embed(img, w, b, 16).float()
    want = pe.patch_embed_plain(img, w, b, 16).float()
    weight = pe.patch_embed_plain(img.abs().float(), w.abs().float(),  # sum |a w|, float32
                                  torch.zeros(768, device="cuda"), 16)
    summed = 2.0 ** -24 * (K * weight + b.float().abs())
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)  # bf16: 8 significant bits
    excess = (got - want).abs() - (step + 2 * summed)
    assert excess.max().item() <= 0, f"{(excess > 0).sum().item()} outputs past the bound"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,P,C,D", [(8, 224, 16, 3, 768), (2, 48, 8, 3, 100)])
def test_patch_embed_gradient_on_the_card(dtype, B, H, P, C, D):
    """The Function's gradients (kernel forward, torch-op backward) for the
    images, the kernel and the bias against autograd through the plain
    version, each in its input's dtype; the forward launches the kernel
    once and the backward nothing."""
    rng = np.random.default_rng(11)
    inputs = _patch_inputs(rng, B, H, P, C, D, dtype)
    cot = _randn(rng, (B, (H // P) ** 2, D), dtype=dtype)
    grads = []
    for fn in (pe.patch_embed, pe.patch_embed_plain):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        before = pe.patch_embed.launches
        fn(*leaves, P).backward(cot)
        torch.cuda.synchronize()
        assert pe.patch_embed.launches - before == (fn is pe.patch_embed)
        grads.append([t.grad for t in leaves])
    assert pe.patch_embed.route == _patch_route(dtype)
    for a, b in zip(*grads):
        assert a.dtype == dtype
        _close(a, b, dtype)


# N of 1 to 4 query tiles of 64, key counts that are not multiples of 8 or
# 16, a unit count (B * H = 133) that does not divide the persistent grid,
# the round's [896, 197, 12 heads], and N past the main paths' bf16
# tensor-core route's 224 keys (225; 257 at 256 px; 577 at 384 px), which
# the key-loop route takes in bf16 and the float32 tensor-core route takes
# as any other N
PACKED_SHAPES = [(3, 197, 12), (2, 100, 4), (2, 64, 2), (1, 224, 1), (1, 1, 2), (2, 8, 3),
                 (3, 63, 4), (2, 65, 3), (133, 100, 1), (896, 197, 12), (2, 225, 12),
                 (2, 257, 12), (2, 577, 4)]
BHND_SHAPES = [(64, 12, 197), (3, 4, 100), (2, 2, 17), (1, 1, 224), (1, 2, 1), (2, 3, 8),
               (2, 2, 63), (3, 2, 64), (2, 3, 65), (133, 1, 100), (896, 12, 197), (2, 12, 225),
               (2, 12, 257), (2, 4, 577)]


def _share_bound(n: int) -> float:
    """The share of n bf16 outputs of the key-loop route that may differ from
    the plain version's: the main paths' kernel's at the round's shape
    (0.22 %, PERF.md) rounded up to 0.25 %, plus four standard deviations of
    a share drawn from n outputs (the small shapes' sampling noise, binomial
    by ``tools/torch_attention_shares.py``'s readings over 32 seeds)."""
    return 0.0025 + 4 * math.sqrt(0.0025 / n)


def _attention_route(dtype, N, d=64):
    """The route of a head dim d (padded as the wrappers pad it): past 128
    bf16 on the wide tensor-core kernel up to 512 and the streamed one past
    it, float32 on the float32 wide tensor-core kernel at any head dim;
    bf16 on the main paths' tensor-core kernel up to 224 keys at head dim
    64 (padded), else on the key-loop one; float32 on the tensor cores
    (3xTF32)."""
    if d > 128:
        if dtype == torch.float32:
            return "tf32x3_wide"
        return "wgmma_wide" if d <= 512 else "wgmma_stream"
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if N <= 224 and d <= 64 else "wgmma_kl"


def _share_differing(got, want):
    return (got != want).float().mean().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,H", PACKED_SHAPES)
def test_attention_kernel_matches_plain(dtype, B, N, H):
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (B, N, H * 64), dtype=dtype) for _ in range(3))
    before = att.fused_attention_packed.launches
    got = att.fused_attention_packed(q, k, v, heads=H)
    torch.cuda.synchronize()
    assert att.fused_attention_packed.launches == before + 1
    assert att.fused_attention_packed.route == _attention_route(dtype, N)
    assert got.dtype == dtype and got.shape == q.shape
    want = att.fused_attention_packed_plain(q, k, v, heads=H)
    _close(got, want, dtype)
    if dtype == torch.bfloat16 and N > 224:
        assert _share_differing(got, want) <= _share_bound(got.numel())


# (M, D, hidden): the tiny (192) and micro (32) widths; M of 1 and of
# ragged 128-row tiles; a hidden width (3000) that is not a multiple of the
# 128-column tile or the 64-wide k stage
MLP_SHAPES = [(591, 768, 3072), (100, 384, 1536), (33, 1024, 4096), (70, 768, 3000),
              (985, 192, 768), (33, 32, 64), (1, 768, 3072), (129, 768, 3000)]
# each dtype on its kernel, at MLP_SHAPES' hidden width and at hidden + 2,
# which is not a multiple of 8 (bf16) or 4 (float32): the wrapper pads it
# with zeros to the next multiple
MLP_ROUTES = [(torch.float32, "tf32x3", 0), (torch.float32, "tf32x3", 2), (torch.bfloat16, "wgmma", 0),
              (torch.bfloat16, "wgmma", 2)]


def _unaligned(t):
    """A contiguous copy of ``t`` one element past an aligned allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _mlp_inputs(rng, M, D, Hd, dtype):
    x = _randn(rng, (M, D), dtype=dtype)
    ls = (1 + _randn(rng, (D,), 0.1)).to(dtype)
    lb = _randn(rng, (D,), 0.1, dtype)
    w1 = _randn(rng, (D, Hd), 0.03, dtype)
    b1 = _randn(rng, (Hd,), 0.1, dtype)
    w2 = _randn(rng, (Hd, D), 0.03, dtype)
    b2 = _randn(rng, (D,), 0.1, dtype)
    return [x, ls, lb, w1, b1, w2, b2]


@pytest.mark.parametrize("dtype,route,extra", MLP_ROUTES)
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("M,D,Hd", MLP_SHAPES)
def test_mlp_kernel_matches_plain(dtype, route, extra, approximate, M, D, Hd):
    rng = np.random.default_rng(2)
    args = _mlp_inputs(rng, M, D, Hd + extra, dtype)
    assert mlp.mlp_route(args[0], args[3], args[5]) == route
    before = mlp.fused_mlp_block.launches
    got = mlp.fused_mlp_block(*args, eps=1e-12, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.launches == before + 1
    assert mlp.fused_mlp_block.route == route
    assert got.dtype == dtype and got.shape == args[0].shape
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12, approximate_gelu=approximate)
    _close(got, want, dtype)


@pytest.mark.parametrize("M,D,Hd,dtype,route", [
    *((M, D, Hd, dt, r) for M, D, Hd in ((33, 32, 64), (129, 768, 3000), (70, 200, 808))
      for dt, r in ((torch.bfloat16, "wgmma"), (torch.float32, "tf32x3"))),
    (70, 36, 100, torch.float32, "tf32x3"),
])
def test_mlp_reads_nothing_past_its_inputs(M, D, Hd, dtype, route):
    """x, W1 and W2 end where NaN rows begin (x past row M, W1 past row D,
    W2 past row Hd), and the workspaces are carved from memory that held
    NaN: a kernel whose TMA boxes read a row past M, a k past K or a
    workspace row past its tensor would put NaN into its outputs. D = 32,
    200 and 36 leave part of the last k stage of fc1 past K (64 wide in
    bf16, 32 in float32), hidden 3000, 808 and 100 that of fc2; D = 36 and
    hidden 100 are float32 only (multiples of 4, not of 8)."""
    rng = np.random.default_rng(11)
    args = _mlp_inputs(rng, M, D, Hd, dtype)
    for i, rows in ((0, 129), (3, 64), (5, 64)):  # x, W1, W2
        t = args[i]
        buf = torch.full((t.shape[0] + rows, t.shape[1]), float("nan"), dtype=t.dtype, device="cuda")
        buf[:t.shape[0]] = t
        args[i] = buf[:t.shape[0]]
    assert mlp.mlp_route(args[0], args[3], args[5]) == route
    poison = torch.full((4 * (M + 128) * (D + Hd) + 4 * D * Hd,), float("nan"), dtype=dtype,
                        device="cuda")
    del poison  # its blocks go back to the caching allocator, NaN inside
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.route == route
    assert torch.isfinite(got.float()).all()
    _close(got, mlp.fused_mlp_block_plain(*args, eps=1e-12), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,Hd", [(129, 768, 3000), (33, 32, 64)])
def test_mlp_unaligned_weights_are_copied_to_the_tensor_cores(dtype, M, D, Hd):
    """W1 and W2 one element past an aligned allocation, which the TMA
    cannot read, are copied to aligned ones and take the dtype's
    tensor-core route (wgmma, tf32x3); the output
    matches the plain version and the caller's weights are unchanged."""
    rng = np.random.default_rng(15)
    args = _mlp_inputs(rng, M, D, Hd, dtype)
    w1, w2 = args[3].clone(), args[5].clone()
    args[3], args[5] = _unaligned(args[3]), _unaligned(args[5])
    assert args[3].data_ptr() % 16 and args[5].data_ptr() % 16
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert mlp.mlp_route(args[0], args[3], args[5]) == route
    before = mlp.fused_mlp_block.launches
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.launches == before + 1
    assert mlp.fused_mlp_block.route == route
    assert torch.equal(args[3], w1) and torch.equal(args[5], w2)
    _close(got, mlp.fused_mlp_block_plain(*args, eps=1e-12), dtype)


def test_mlp_float32_at_the_round_shape():
    """The tf32x3 route at the round's float32 shape (7 coalitions x 128
    images x 197 tokens, ViT-B widths) within the float32 tolerance of the
    plain version (full float32 products: TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator(device="cuda").manual_seed(0)
    M, D, Hd = 7 * 128 * 197, 768, 3072

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    args = [randn((M, D)), 1 + randn((D,), 0.1), randn((D,), 0.1),
            randn((D, Hd), 0.03), randn((Hd,), 0.1), randn((Hd, D), 0.03), randn((D,), 0.1)]
    assert mlp.mlp_route(args[0], args[3], args[5]) == "tf32x3"
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12)
    torch.cuda.synchronize()
    print(f"max_abs_err {(got - want).abs().max().item()}")
    _close(got, want, torch.float32)


def test_mlp_bf16_at_the_round_shape():
    """The wgmma route at the round's shape (7 coalitions x 128 images x 197
    tokens, ViT-B widths) within the bf16 tolerance of the plain version; the
    share of outputs whose bf16 value differs from the plain version's is
    printed (y and h are rounded to bf16 where the plain version rounds
    them, so only the order of the float32 sums differs)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    M, D, Hd = 7 * 128 * 197, 768, 3072

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    args = [randn((M, D)), (1 + randn((D,), 0.1).float()).bfloat16(), randn((D,), 0.1),
            randn((D, Hd), 0.03), randn((Hd,), 0.1), randn((Hd, D), 0.03), randn((D,), 0.1)]
    assert mlp.mlp_route(args[0], args[3], args[5]) == "wgmma"
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12)
    torch.cuda.synchronize()
    differing = (got != want).float().mean().item()
    print(f"max_abs_err {(got.float() - want.float()).abs().max().item()} "
          f"share_differing {differing}")
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,N", BHND_SHAPES)
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
    assert att.fused_attention.route == _attention_route(dtype, N)
    assert got.dtype == dtype and got.shape == (B, H, N, 64) and got.stride() == q.stride()
    want = att.fused_attention_plain(q, k, v)
    _close(got, want, dtype)
    if dtype == torch.bfloat16 and N > 224:
        assert _share_differing(got, want) <= _share_bound(got.numel())


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 80, 96, 128])
@pytest.mark.parametrize("B,N,H", [(3, 197, 2), (2, 17, 3), (896, 17, 2), (2, 225, 3), (2, 257, 2),
                                   (2, 577, 1)])
def test_attention_narrow_head_dims(dtype, d, B, N, H):
    """Head dims under 64 (micro's 16) are zero-padded to 64 by both
    wrappers, and those of 65 to 127 (80, ViT-H/14's; 96) to 128, with the
    true head dim's scale, and cut back; 128 runs as it is. bf16 at head
    dim 128 or past 224 keys takes the key-loop tensor-core route."""
    _check_head_dim(dtype, d, B, N, H)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [136, 256, 384, 448, 512, 576, 1024])
@pytest.mark.parametrize("B,N,H", [(3, 197, 2), (2, 17, 3), (2, 257, 2)])
def test_attention_wide_head_dims(dtype, d, B, N, H):
    """Head dims past 128, zero-padded to a multiple of 64 (136 to 192)
    with the true head dim's scale and cut back, the others run as they
    are: bf16 on the wide tensor-core route up to 512 (an odd number of
    64-column panels at 192 and 448, 32-key blocks at 448 and 512) and on
    the streamed one at 576 and 1024, float32 on the float32 wide
    tensor-core route at every one (a last output panel 64 columns wide at
    192, 448 and 576; 32 streamed panels of d at 1024)."""
    _check_head_dim(dtype, d, B, N, H)


@pytest.mark.parametrize("N", [17, 197, 577])
@pytest.mark.parametrize("H,d", [(1, 576), (1, 640), (2, 576), (1, 1024)])
def test_attention_stream_head_dims(H, d, N):
    """bf16 past head dim 512 on the streamed tensor-core route (Q and K in
    64-column panels of d through a ring; 5, 5, 5 and 8 output panels, the
    last 64 wide at 576), both entries against their plain versions and
    within ``_share_bound``, at one and two heads and N of one, two and
    five query units."""
    assert _attention_route(torch.bfloat16, N, d) == "wgmma_stream"
    _check_head_dim(torch.bfloat16, d, 2, N, H)


def _check_head_dim(dtype, d, B, N, H):
    """Both entries at head dim d against their plain versions, on the
    route of d, N and dtype; on the key-loop and wide routes the share of
    outputs that differ from the plain version's within ``_share_bound``."""
    rng = np.random.default_rng(12)
    q, k, v = (_randn(rng, (B, N, H * d), dtype=dtype) for _ in range(3))
    before = att.fused_attention_packed.launches
    got = att.fused_attention_packed(q, k, v, heads=H)
    torch.cuda.synchronize()
    assert att.fused_attention_packed.launches == before + 1
    assert att.fused_attention_packed.route == _attention_route(dtype, N, d)
    assert got.dtype == dtype and got.shape == q.shape
    want = att.fused_attention_packed_plain(q, k, v, heads=H)
    _close(got, want, dtype)
    if att.fused_attention_packed.route in ("wgmma_kl", "wgmma_wide", "wgmma_stream"):
        assert _share_differing(got, want) <= _share_bound(got.numel())
    qh, kh, vh = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
    before = att.fused_attention.launches
    got = att.fused_attention(qh, kh, vh)
    torch.cuda.synchronize()
    assert att.fused_attention.launches == before + 1
    assert att.fused_attention.route == _attention_route(dtype, N, d)
    assert got.dtype == dtype and got.shape == (B, H, N, d)
    want = att.fused_attention_plain(qh, kh, vh)
    _close(got, want, dtype)
    if att.fused_attention.route in ("wgmma_kl", "wgmma_wide", "wgmma_stream"):
        assert _share_differing(got, want) <= _share_bound(got.numel())


def test_bhnd_attention_gradient_at_head_dim_256():
    """The gradient through the wide tensor-core route's forward (bf16,
    [2, 3, 197, 256]) against autograd through the plain version; the
    backward launches nothing."""
    rng = np.random.default_rng(15)
    B, H, N, d = 2, 3, 197, 256
    base = [_randn(rng, (B, N, H * d), dtype=torch.bfloat16) for _ in range(3)]
    cot = _randn(rng, (B, H, N, d), dtype=torch.bfloat16)
    grads = []
    for fn in (att.fused_attention, att.fused_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(*[t.view(B, N, H, d).transpose(1, 2) for t in leaves])
        if fn is att.fused_attention:
            assert att.fused_attention.route == "wgmma_wide"
        before = att.fused_attention.launches
        out.backward(cot)
        assert att.fused_attention.launches == before
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close(a, b, torch.bfloat16)


def test_bhnd_attention_float32_gradient_at_head_dim_256():
    """The gradient through the float32 wide tensor-core route's forward
    ([2, 3, 197, 256]) against autograd through the plain version; the
    backward launches nothing."""
    rng = np.random.default_rng(16)
    B, H, N, d = 2, 3, 197, 256
    base = [_randn(rng, (B, N, H * d)) for _ in range(3)]
    cot = _randn(rng, (B, H, N, d))
    grads = []
    for fn in (att.fused_attention, att.fused_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(*[t.view(B, N, H, d).transpose(1, 2) for t in leaves])
        if fn is att.fused_attention:
            assert att.fused_attention.route == "tf32x3_wide"
        before = att.fused_attention.launches
        out.backward(cot)
        assert att.fused_attention.launches == before
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close(a, b, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bhnd_attention_gradient_at_head_dim_16(dtype):
    """The padded forward's gradient: the backward recomputes on the
    unpadded tensors, as at head dim 64."""
    rng = np.random.default_rng(13)
    B, H, N, d = 4, 2, 65, 16
    base = [_randn(rng, (B, N, H * d), dtype=dtype) for _ in range(3)]
    cot = _randn(rng, (B, H, N, d), dtype=dtype)
    grads = []
    for fn in (att.fused_attention, att.fused_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(*[t.view(B, N, H, d).transpose(1, 2) for t in leaves])
        out.backward(cot)
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


@pytest.mark.parametrize("N", [197, 257])
def test_attention_bf16_unaligned_tensors_are_copied_to_the_tensor_cores(N):
    """bf16 tensors that are not 16-byte aligned, which the TMA cannot read,
    are copied to aligned ones and take the tensor-core route of their N
    (the main paths' kernel up to 224 keys, the key-loop one past them);
    both entries match the plain version."""
    rng = np.random.default_rng(4)
    B, H = 2, 12
    q, k, v = (_unaligned(_randn(rng, (B, N, H * 64), dtype=torch.bfloat16)) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    got = att.fused_attention_packed(q, k, v, heads=H)
    assert att.fused_attention_packed.route == _attention_route(torch.bfloat16, N)
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), torch.bfloat16)
    qh, kh, vh = (t.view(B, N, H, 64).transpose(1, 2) for t in (q, k, v))
    got = att.fused_attention(qh, kh, vh)
    assert att.fused_attention.route == _attention_route(torch.bfloat16, N)
    _close(got, att.fused_attention_plain(qh, kh, vh), torch.bfloat16)


def test_attention_float32_unaligned_tensors_are_copied_to_the_tf32x3_path():
    """float32 tensors that are not 16-byte aligned, which the TMA cannot
    read, are copied to aligned ones and take the 3xTF32 path, the only
    float32 one; both entries match the plain version."""
    rng = np.random.default_rng(14)
    B, N, H = 2, 257, 12

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v = (unaligned(_randn(rng, (B, N, H * 64))) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    got = att.fused_attention_packed(q, k, v, heads=H)
    assert att.fused_attention_packed.route == "tf32x3"
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), torch.float32)
    qh, kh, vh = (t.view(B, N, H, 64).transpose(1, 2) for t in (q, k, v))
    got = att.fused_attention(qh, kh, vh)
    assert att.fused_attention.route == "tf32x3"
    _close(got, att.fused_attention_plain(qh, kh, vh), torch.float32)


@pytest.mark.parametrize("d", [192, 256])
def test_attention_float32_unaligned_wide_heads_are_copied_to_the_tensor_cores(d):
    """float32 tensors past head dim 128 that are not 16-byte aligned are
    copied to aligned ones and take the float32 wide tensor-core route;
    both entries match the plain version."""
    rng = np.random.default_rng(17)
    B, N, H = 2, 197, 2
    q, k, v = (_unaligned(_randn(rng, (B, N, H * d))) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16
    got = att.fused_attention_packed(q, k, v, heads=H)
    assert att.fused_attention_packed.route == "tf32x3_wide"
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), torch.float32)
    qh, kh, vh = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
    got = att.fused_attention(qh, kh, vh)
    assert att.fused_attention.route == "tf32x3_wide"
    _close(got, att.fused_attention_plain(qh, kh, vh), torch.float32)


@pytest.mark.parametrize("entry", ["packed", "bhnd"])
@pytest.mark.parametrize("d", [192, 320])
@pytest.mark.parametrize("nan_in", ["next_head", "next_image"])
def test_attention_float32_wide_reads_nothing_past_its_head(entry, d, nan_in):
    """The float32 wide tensor-core route reads no column past d and no
    row past N: with the last head's q, k and v NaN, the other heads'
    outputs (whose last output panel, at d = 192 and 320, reaches past d
    into the next head's columns) stay finite and match the plain version;
    with the next image NaN, every output does."""
    rng = np.random.default_rng(18)
    B, N, H = 3, 197, 3
    bufs = []
    for _ in range(3):
        buf = torch.full((B + 1, N, H * d), float("nan"), device="cuda")
        buf[:B] = _randn(rng, (B, N, H * d))
        if nan_in == "next_head":
            buf[:B, :, (H - 1) * d:] = float("nan")
        bufs.append(buf)
    q, k, v = (b[:B] for b in bufs)
    if entry == "packed":
        got = att.fused_attention_packed(q, k, v, heads=H).view(B, N, H, d).transpose(1, 2)
        want = att.fused_attention_packed_plain(q, k, v, heads=H).view(B, N, H, d).transpose(1, 2)
        route = att.fused_attention_packed.route
    else:
        q, k, v = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
        got, want = att.fused_attention(q, k, v), att.fused_attention_plain(q, k, v)
        route = att.fused_attention.route
    torch.cuda.synchronize()
    assert route == "tf32x3_wide"
    kept = H - 1 if nan_in == "next_head" else H
    assert torch.isfinite(got[:, :kept]).all()
    _close(got[:, :kept], want[:, :kept], torch.float32)


def test_attention_float32_at_the_round_shape():
    """The tf32x3 route at the float32 round's shape ([896, 197, 768], 12
    heads, chip_smoke's inputs' distribution) within 1e-4 of the plain
    version: each product in 3xTF32, the tensor cores' truncating sums cut
    to one key block's products."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((896, 197, 768), generator=gen, device="cuda") for _ in range(3))
    got = att.fused_attention_packed(q, k, v, heads=12)
    assert att.fused_attention_packed.route == "tf32x3"
    want = att.fused_attention_packed_plain(q, k, v, heads=12)
    err = (got - want).abs().max().item()
    print(f"max_abs_err {err}")
    _close(got, want, torch.float32)


def test_attention_tensor_core_entries_refuse_what_they_do_not_take():
    """The tensor-core entries refuse unaligned tensors, strides that are not
    multiples of 16 bytes and head dims other than 64 and 128 (the bf16 main
    paths' entry, which takes no head dim, N past 224; the bf16 wide entry
    head dims other than 192, 256, ..., 512; the bf16 streamed entry head
    dims up to 512 or off the multiples of 64; the float32 wide entry head
    dims under 192 or off the multiples of 64): each with an error and no
    launch, rather than running another kernel."""
    from shapley_vit_tpu_torch.ops import _build

    lib = _build.load("attention", att._FNS)
    stream = torch.cuda.current_stream().cuda_stream
    B, N, H = 2, 17, 2
    for dtype, entry, d, n, offset, pad in ((torch.float32, "tf32x3", 64, N, 1, 0),
                                            (torch.float32, "tf32x3", 80, N, 0, 0),
                                            (torch.float32, "tf32x3", 256, N, 0, 0),
                                            (torch.bfloat16, "bf16", 64, 225, 0, 0),
                                            (torch.bfloat16, "bf16_kl", 64, N, 1, 0),
                                            (torch.bfloat16, "bf16_kl", 64, N, 0, 4),
                                            (torch.bfloat16, "bf16_kl", 80, N, 0, 0),
                                            (torch.bfloat16, "bf16_kl", 256, 577, 0, 0),
                                            (torch.bfloat16, "bf16_wide", 256, N, 1, 0),
                                            (torch.bfloat16, "bf16_wide", 256, N, 0, 4),
                                            (torch.bfloat16, "bf16_wide", 128, N, 0, 0),
                                            (torch.bfloat16, "bf16_wide", 576, N, 0, 0),
                                            (torch.bfloat16, "bf16_wide", 200, N, 0, 0),
                                            (torch.bfloat16, "bf16_stream", 576, N, 1, 0),
                                            (torch.bfloat16, "bf16_stream", 576, N, 0, 4),
                                            (torch.bfloat16, "bf16_stream", 512, N, 0, 0),
                                            (torch.bfloat16, "bf16_stream", 600, N, 0, 0),
                                            (torch.float32, "tf32x3_wide", 256, N, 1, 0),
                                            (torch.float32, "tf32x3_wide", 256, N, 0, 2),
                                            (torch.float32, "tf32x3_wide", 128, N, 0, 0),
                                            (torch.float32, "tf32x3_wide", 200, N, 0, 0)):
        # a row stride of H d + 4 (bf16) or + 2 (float32): not a multiple of 16 bytes
        row = H * d + pad
        buf = torch.zeros(4 * B * n * row + 8, dtype=dtype, device="cuda")
        q, k, v, o = (buf[offset + i * B * n * row:].data_ptr() for i in range(4))
        dims = (B, H, n) if entry == "bf16" else (B, H, n, d)
        err = getattr(lib, f"svt_attention_bhnd_{entry}")(q, k, v, o, *dims, n * row, d, row,
                                                           0.125, stream)
        torch.cuda.synchronize()
        assert err != 0, (entry, d, n, offset, pad)
        assert torch.count_nonzero(buf) == 0


def test_attention_bf16_entry_refuses_what_tma_cannot_read():
    """The tensor-core entry takes only what ``attention_route`` sends it:
    given unaligned bf16 tensors it returns an error and launches nothing,
    rather than running another kernel."""
    from shapley_vit_tpu_torch.ops import _build

    lib = _build.load("attention", att._FNS)
    B, N, H = 2, 17, 2
    buf = torch.zeros(4 * B * N * H * 64 + 1, dtype=torch.bfloat16, device="cuda")
    q, k, v, o = (buf[1 + i * B * N * H * 64:].data_ptr() for i in range(4))
    err = lib.svt_attention_bhnd_bf16(q, k, v, o, B, H, N, N * H * 64, 64, H * 64, 0.125,
                                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0
    assert torch.count_nonzero(buf) == 0


@pytest.mark.parametrize("entry", ["packed", "bhnd"])
@pytest.mark.parametrize("N,H,d", [(197, 12, 64), (257, 12, 64), (197, 6, 128), (197, 3, 256),
                                   (197, 4, 192), (197, 1, 576)])
def test_attention_reads_no_row_past_the_last_image(entry, N, H, d):
    """q, k and v end where a NaN image begins: a kernel that read rows at or
    past N of the last image would put NaN into its outputs. Each bf16
    route: the main paths' (N = 197), the key-loop one (N = 257, head dim
    128), the wide one (head dims 256 and 192; at 192 the second output
    panel's columns past d are, packed, the next head's, and on the last
    head the NaN image's) and the streamed one (head dim 576, whose last
    output panel reaches past d)."""
    rng = np.random.default_rng(8)
    B = 3
    bufs = []
    for _ in range(3):
        buf = torch.full((B + 1, N, H * d), float("nan"), dtype=torch.bfloat16, device="cuda")
        buf[:B] = _randn(rng, (B, N, H * d), dtype=torch.bfloat16)
        bufs.append(buf)
    q, k, v = (b[:B] for b in bufs)
    if entry == "packed":
        got = att.fused_attention_packed(q, k, v, heads=H)
        want = att.fused_attention_packed_plain(q, k, v, heads=H)
        route = att.fused_attention_packed.route
    else:
        q, k, v = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
        got, want = att.fused_attention(q, k, v), att.fused_attention_plain(q, k, v)
        route = att.fused_attention.route
    torch.cuda.synchronize()
    assert route == _attention_route(torch.bfloat16, N, d)
    assert torch.isfinite(got.float()).all()
    _close(got, want, torch.bfloat16)


def round_shape_inputs():
    """q, k, v ``[896, 197, 768]`` bf16 (the round's shape, 12 heads), drawn
    from seed 0 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn((896, 197, 768), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def _key_loop_packed(q, k, v, heads):
    """The key-loop bf16 kernel on packed [B, N, H d] tensors through its C
    entry (the wrappers send it only N past 224 or head dim 128)."""
    from shapley_vit_tpu_torch.ops import _build

    lib = _build.load("attention", att._FNS)
    B, N, HD = q.shape
    d = HD // heads
    out = torch.empty_like(q)
    err = lib.svt_attention_bhnd_bf16_kl(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         B, heads, N, d, N * HD, d, HD, 1.0 / d ** 0.5,
                                         torch.cuda.current_stream().cuda_stream)
    _build.check(err, "svt_attention_bhnd_bf16_kl")
    return out


@pytest.mark.parametrize("route", ["wgmma", "wgmma_kl"])
def test_attention_bf16_error_at_the_round_shape(route):
    """The bf16 tensor-core kernels against the plain version (float32
    scores, softmax and products, output rounded to bf16) at the round's
    shape: the main paths' kernel through the wrapper, and the key-loop
    kernel (64-key blocks, an online softmax) through its entry on the same
    inputs. Both multiply p v as p_hi v + p_lo v on the tensor cores (p_hi =
    bf16(p), p_lo = bf16(p - p_hi)), which keeps p to 16 bits: |p - p_hi -
    p_lo| <= 2^-18 p, so the float32 output is within 2^-18 sum_j p_j |v_j|
    of the plain version's (2^-17 here, for the float32 sums of either). Two
    float32 values that close round to bf16 values at most that far apart
    plus one bf16 step of the larger. Rounding p to bf16 alone (2^-9 p)
    would break this bound.

    It does not meet the precision of an FMA kernel (float32 p v). On an
    H100 at these inputs (tools/torch_attention_ab.py), the main paths'
    kernel's largest difference from the plain version is one bf16 step at
    |o| in [0.5, 1), 2^-8, where a float32 p v's was 2^-9, and 0.22 % of the
    outputs differ from the plain version's bf16 value against 0.023 %: 16
    bits of p carry an output across a bf16 rounding boundary more often
    than float32 does. Both shares are held within ``_share_bound`` and
    printed."""
    H = 12
    q, k, v = round_shape_inputs()
    if route == "wgmma":
        got = att.fused_attention_packed(q, k, v, heads=H)
        assert att.fused_attention_packed.route == "wgmma"
    else:
        got = _key_loop_packed(q, k, v, H)
    want = att.fused_attention_packed_plain(q, k, v, heads=H)
    share = _share_differing(got, want)
    print(f"{route} share_differing {share}")
    got, want = got.float(), want.float()
    B, N, HD = q.shape
    qh, kh, vh = (t.float().view(B, N, H, HD // H).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / 8.0, dim=-1)
    weight = (p @ vh.abs()).transpose(1, 2).reshape(B, N, HD)  # sum_j p_j |v_j|
    del p, qh, kh, vh
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)  # bf16: 8 significant bits
    excess = (got - want).abs() - (2.0 ** -17 * weight + step)
    assert excess.max().item() <= 0, f"{(excess > 0).sum().item()} outputs past the bound"
    assert share <= _share_bound(got.numel())


@pytest.mark.parametrize("dtype,D", [(torch.float32, 202), (torch.float32, 1030),
                                     (torch.bfloat16, 36), (torch.bfloat16, 202)])
@pytest.mark.parametrize("Hd", [128, 3070])
def test_mlp_pads_widths_onto_the_tensor_cores(dtype, D, Hd):
    """D and hidden widths that are not multiples of 8 (bf16) or 4
    (float32), which the TMA cannot read as they are, are zero-padded by
    the wrapper and run on the dtype's tensor-core route, the LN statistics
    over the true D: the output, cut back to D, matches the plain version
    and the caller's tensors are unchanged."""
    rng = np.random.default_rng(D + Hd)
    args = _mlp_inputs(rng, 197, D, Hd, dtype)
    kept = [t.clone() for t in args]
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = mlp.fused_mlp_block.launches
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.launches == before + 1
    assert mlp.fused_mlp_block.route == route
    assert got.shape == (197, D) and got.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(args, kept))
    _close(got, mlp.fused_mlp_block_plain(*args, eps=1e-12), dtype)


def test_kernels_reject_what_they_do_not_take():
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 10, 0))  # head dim 0
    with pytest.raises(ValueError, match="head dim"):
        att.fused_attention_packed(q, q, q, heads=4)
    qh = q.view(2, 10, 4, 0).transpose(1, 2)
    with pytest.raises(ValueError, match="head dim"):
        att.fused_attention(qh, qh, qh)
    x = _randn(rng, (4, 64))
    w = _randn(rng, (64, 128))
    with pytest.raises(ValueError, match="shapes"):
        mlp.fused_mlp_block(x, x[0], x[0], w, w[0], w, x[0])
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


# ---------------------------------------------------------------------------
# int8 (W8A8): torch._int_mm on the card against the same call on the CPU
# ---------------------------------------------------------------------------

from shapley_vit_tpu_torch.ops import quant  # noqa: E402


# rows: fewer than the 17 cuBLASLt takes (padded), exactly 17, a row count
# that is no multiple of any tile; K and N the ViT-B widths and narrow ones;
# K and N off the multiples of 8 (padded with zero codes; K = 588: a patch of
# 14 at 3 channels)
@pytest.mark.parametrize("M,K,N", [(1, 768, 768), (16, 64, 32), (17, 768, 3072),
                                   (985, 192, 768), (197, 768, 768), (20, 12, 8),
                                   (20, 16, 6), (985, 588, 762)])
def test_int8_matmul_matches_the_cpu(M, K, N):
    gen = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
    got = quant.int8_matmul(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu(), quant.int8_matmul(a, b))  # int32: exact


@pytest.mark.parametrize("C", [0, 3])
def test_dynamic_int8_dense_matches_the_cpu(C):
    """Shared ([K, N]) and per-coalition ([C, K, N]) kernels: the same codes,
    scales and int32 sums on both devices; the float32 outputs within 1e-6."""
    rng = np.random.default_rng(C)
    lead = (C,) if C else (2,)
    x = torch.as_tensor(rng.normal(size=(*lead, 197, 768)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(*((C,) if C else ()), 768, 768)) * 0.03,
                        dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=768) * 0.1, dtype=torch.float32)
    want = quant.dynamic_int8_dense(x, w, b)
    got = quant.dynamic_int8_dense(x.cuda(), w.cuda(), b.cuda())
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)
    for dev in ("cpu", "cuda"):
        q, s = quant.quantize_symmetric(x.to(dev), dim=-1)
        assert torch.equal(q.cpu(), quant.quantize_symmetric(x, dim=-1)[0])
        assert torch.equal(s.cpu(), quant.quantize_symmetric(x, dim=-1)[1])


def test_int8_refuses_on_the_card_what_it_refuses_on_the_cpu():
    with pytest.raises(ValueError, match="overflow"):
        quant.int8_matmul(torch.ones((20, 133_152), dtype=torch.int8, device="cuda"),
                          torch.ones((133_152, 8), dtype=torch.int8, device="cuda"))
