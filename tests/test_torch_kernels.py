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


# The bf16 kernel's routes: W by TMA where D % 8 == 0, else by cp.async
# (D = 100: 8-byte copies; D = 33: 2-byte copies, odd D); patch rows by
# 16-byte copies where P*C % 8 == 0, else narrower (P*C = 12: 8 bytes;
# P*C = 15 or 5: 2 bytes). The round's (B = 128) and the training batch's
# (64) shapes; B*N not a multiple of the 128-row tile (3 x 196, 1 x 4); D
# not a multiple of the 128-column tile (100, 200, 33, 64); K = 48 and 75,
# less than one 64-wide k stage.
PATCH_SHAPES = [(3, 224, 16, 3, 768), (2, 48, 8, 3, 100), (128, 224, 16, 3, 768),
                (64, 224, 16, 3, 768), (1, 32, 16, 3, 256), (2, 224, 16, 3, 200),
                (2, 32, 4, 3, 64), (2, 15, 5, 3, 64), (2, 30, 5, 1, 33)]


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
    assert pe.patch_embed.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
    assert got.dtype == dtype and got.shape == (B, (H // P) ** 2, D)
    _close(got, pe.patch_embed_plain(img, w, b, P), dtype)


@pytest.mark.parametrize("B,H,P,C,D", [(3, 224, 16, 3, 768), (2, 32, 4, 3, 64), (2, 32, 4, 3, 100)])
def test_patch_embed_reads_nothing_past_the_last_image(B, H, P, C, D):
    """The images end where a NaN image begins, and W where NaN rows begin:
    a bf16 kernel that read a patch row past the last image, a k past
    K = P*P*C (48 < 64 here for P = 4) or a W row past K would put NaN into
    its outputs. W by TMA (D = 768, 64) and by cp.async (D = 100)."""
    rng = np.random.default_rng(9)
    img, w, b = _patch_inputs(rng, B, H, P, C, D, torch.bfloat16)
    ibuf = torch.full((B + 1, H, H, C), float("nan"), dtype=torch.bfloat16, device="cuda")
    ibuf[:B] = img
    wbuf = torch.full((P * P * C + 64, D), float("nan"), dtype=torch.bfloat16, device="cuda")
    wbuf[:P * P * C] = w
    got = pe.patch_embed(ibuf[:B], wbuf[:P * P * C], b, P)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, pe.patch_embed_plain(img, w, b, P), torch.bfloat16)


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
    assert pe.patch_embed.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
    for a, b in zip(*grads):
        assert a.dtype == dtype
        _close(a, b, dtype)


# N of 1 to 4 query tiles of 64, key counts that are not multiples of 8 or
# 16, a unit count (B * H = 133) that does not divide the persistent grid,
# and the round's [896, 197, 12 heads]
PACKED_SHAPES = [(3, 197, 12), (2, 100, 4), (2, 64, 2), (1, 224, 1), (1, 1, 2), (2, 8, 3),
                 (3, 63, 4), (2, 65, 3), (133, 100, 1), (896, 197, 12)]
BHND_SHAPES = [(64, 12, 197), (3, 4, 100), (2, 2, 17), (1, 1, 224), (1, 2, 1), (2, 3, 8),
               (2, 2, 63), (3, 2, 64), (2, 3, 65), (133, 1, 100), (896, 12, 197)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,H", PACKED_SHAPES)
def test_attention_kernel_matches_plain(dtype, B, N, H):
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, (B, N, H * 64), dtype=dtype) for _ in range(3))
    before = att.fused_attention_packed.launches
    got = att.fused_attention_packed(q, k, v, heads=H)
    torch.cuda.synchronize()
    assert att.fused_attention_packed.launches == before + 1
    assert att.fused_attention_packed.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), dtype)


# (M, D, hidden): the tiny (192) and micro (32) widths; M of 1 and of
# ragged 128-row tiles; a hidden width (3000) that is not a multiple of the
# 128-column tile or the 64-wide k stage
MLP_SHAPES = [(591, 768, 3072), (100, 384, 1536), (33, 1024, 4096), (70, 768, 3000),
              (985, 192, 768), (33, 32, 64), (1, 768, 3072), (129, 768, 3000)]
# each dtype on each kernel that takes it: bf16 takes the FMA kernel where the
# weights are not 16-byte aligned
MLP_ROUTES = [(torch.float32, "fma"), (torch.bfloat16, "wgmma"), (torch.bfloat16, "fma")]


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


@pytest.mark.parametrize("dtype,route", MLP_ROUTES)
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("M,D,Hd", MLP_SHAPES)
def test_mlp_kernel_matches_plain(dtype, route, approximate, M, D, Hd):
    rng = np.random.default_rng(2)
    args = _mlp_inputs(rng, M, D, Hd, dtype)
    if route == "fma" and dtype == torch.bfloat16:
        args[3], args[5] = _unaligned(args[3]), _unaligned(args[5])
    assert mlp.mlp_route(args[0], args[3], args[5]) == route
    before = mlp.fused_mlp_block.launches
    got = mlp.fused_mlp_block(*args, eps=1e-12, approximate_gelu=approximate)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_block.launches == before + 1
    assert mlp.fused_mlp_block.route == route
    assert got.dtype == dtype and got.shape == args[0].shape
    want = mlp.fused_mlp_block_plain(*args, eps=1e-12, approximate_gelu=approximate)
    _close(got, want, dtype)


@pytest.mark.parametrize("M,D,Hd", [(33, 32, 64), (129, 768, 3000), (70, 200, 808)])
def test_mlp_reads_nothing_past_its_inputs(M, D, Hd):
    """x, W1 and W2 end where NaN rows begin (x past row M, W1 past row D,
    W2 past row Hd), and the workspaces are carved from memory that held
    NaN: a bf16 kernel whose TMA boxes read a row past M, a k past K or a
    workspace row past its tensor would put NaN into its outputs. D = 32
    and 200 leave part of the last 64-wide k stage of fc1 past K, hidden
    3000 and 808 that of fc2."""
    rng = np.random.default_rng(11)
    args = _mlp_inputs(rng, M, D, Hd, torch.bfloat16)
    for i, rows in ((0, 129), (3, 64), (5, 64)):  # x, W1, W2
        t = args[i]
        buf = torch.full((t.shape[0] + rows, t.shape[1]), float("nan"), dtype=t.dtype, device="cuda")
        buf[:t.shape[0]] = t
        args[i] = buf[:t.shape[0]]
    assert mlp.mlp_route(args[0], args[3], args[5]) == "wgmma"
    poison = torch.full((4 * (M + 128) * (D + Hd),), float("nan"), dtype=torch.bfloat16,
                        device="cuda")
    del poison  # its blocks go back to the caching allocator, NaN inside
    got = mlp.fused_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, mlp.fused_mlp_block_plain(*args, eps=1e-12), torch.bfloat16)


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
    assert att.fused_attention.route == ("wgmma" if dtype == torch.bfloat16 else "fma")
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("B,N,H", [(3, 197, 2), (2, 17, 3), (896, 17, 2)])
def test_attention_narrow_head_dims(dtype, d, B, N, H):
    """Head dims under 64 (micro's 16) are zero-padded to 64 by both
    wrappers, with the true head dim's scale, and cut back."""
    rng = np.random.default_rng(12)
    q, k, v = (_randn(rng, (B, N, H * d), dtype=dtype) for _ in range(3))
    before = att.fused_attention_packed.launches
    got = att.fused_attention_packed(q, k, v, heads=H)
    torch.cuda.synchronize()
    assert att.fused_attention_packed.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), dtype)
    qh, kh, vh = (t.view(B, N, H, d).transpose(1, 2) for t in (q, k, v))
    before = att.fused_attention.launches
    got = att.fused_attention(qh, kh, vh)
    torch.cuda.synchronize()
    assert att.fused_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, N, d)
    _close(got, att.fused_attention_plain(qh, kh, vh), dtype)


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


def test_attention_bf16_unaligned_tensors_take_the_fma_path():
    """bf16 tensors that are not 16-byte aligned skip the TMA path (16-byte
    aligned addresses and strides) for the FMA one; both match the plain
    version."""
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
    assert att.fused_attention_packed.route == "fma"
    _close(got, att.fused_attention_packed_plain(q, k, v, heads=H), torch.bfloat16)


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
def test_attention_reads_no_row_past_the_last_image(entry):
    """q, k and v end where a NaN image begins: a kernel that read rows at or
    past N of the last image would put NaN into its outputs."""
    rng = np.random.default_rng(8)
    B, N, H = 3, 197, 12
    bufs = []
    for _ in range(3):
        buf = torch.full((B + 1, N, H * 64), float("nan"), dtype=torch.bfloat16, device="cuda")
        buf[:B] = _randn(rng, (B, N, H * 64), dtype=torch.bfloat16)
        bufs.append(buf)
    q, k, v = (b[:B] for b in bufs)
    if entry == "packed":
        got = att.fused_attention_packed(q, k, v, heads=H)
        want = att.fused_attention_packed_plain(q, k, v, heads=H)
    else:
        q, k, v = (t.view(B, N, H, 64).transpose(1, 2) for t in (q, k, v))
        got, want = att.fused_attention(q, k, v), att.fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, want, torch.bfloat16)


def round_shape_inputs():
    """q, k, v ``[896, 197, 768]`` bf16 (the round's shape, 12 heads), drawn
    from seed 0 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn((896, 197, 768), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def test_attention_bf16_error_at_the_round_shape():
    """The bf16 kernel against the plain version (float32 scores, softmax and
    products, output rounded to bf16) at the round's shape. The kernel
    multiplies p v as p_hi v + p_lo v on the tensor cores (p_hi = bf16(p),
    p_lo = bf16(p - p_hi)), which keeps p to 16 bits: |p - p_hi - p_lo| <=
    2^-18 p, so its float32 output is within 2^-18 sum_j p_j |v_j| of the
    plain version's (2^-17 here, for the float32 sums of either). Two float32
    values that close round to bf16 values at most that far apart plus one
    bf16 step of the larger. Rounding p to bf16 alone (2^-9 p) would break
    this bound.

    It does not meet the previous kernel's precision (float32 p v on the FMA
    units). On an H100 at these inputs (tools/torch_attention_ab.py), the
    largest difference from the plain version is one bf16 step at |o| in
    [0.5, 1), 2^-8, where the previous kernel's was 2^-9, and 0.22 % of the
    outputs differ from the plain version's bf16 value against 0.023 %:
    16 bits of p carry an output across a bf16 rounding boundary more often
    than float32 does. Against the float64 result both kernels have the
    same largest error."""
    H = 12
    q, k, v = round_shape_inputs()
    got = att.fused_attention_packed(q, k, v, heads=H).float()
    want = att.fused_attention_packed_plain(q, k, v, heads=H).float()
    B, N, HD = q.shape
    qh, kh, vh = (t.float().view(B, N, H, HD // H).transpose(1, 2) for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / 8.0, dim=-1)
    weight = (p @ vh.abs()).transpose(1, 2).reshape(B, N, HD)  # sum_j p_j |v_j|
    del p, qh, kh, vh
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)  # bf16: 8 significant bits
    excess = (got - want).abs() - (2.0 ** -17 * weight + step)
    assert excess.max().item() <= 0, f"{(excess > 0).sum().item()} outputs past the bound"


def test_kernels_reject_what_they_do_not_take():
    rng = np.random.default_rng(3)
    for d in (12, 80):  # not a multiple of 8; wider than 64
        q = _randn(rng, (2, 10, 4 * d))
        with pytest.raises(ValueError, match="head dim"):
            att.fused_attention_packed(q, q, q, heads=4)
        qh = q.view(2, 10, 4, d).transpose(1, 2)
        with pytest.raises(ValueError, match="head dim"):
            att.fused_attention(qh, qh, qh)
    long = _randn(rng, (1, 1, 300, 64))
    with pytest.raises(ValueError, match="sequence length"):
        att.fused_attention(long, long, long)
    for dtype, D in ((torch.float32, 200), (torch.float32, 1056), (torch.bfloat16, 36)):
        x = _randn(rng, (4, D), dtype=dtype)
        w = _randn(rng, (D, 128), dtype=dtype)
        with pytest.raises(ValueError, match="taken by no kernel"):
            mlp.fused_mlp_block(x, x[0], x[0], w, w[0], w.T.contiguous(), x[0])
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
# that is no multiple of any tile; K and N the ViT-B widths and narrow ones
@pytest.mark.parametrize("M,K,N", [(1, 768, 768), (16, 64, 32), (17, 768, 3072),
                                   (985, 192, 768), (197, 768, 768)])
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
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.dynamic_int8_dense(torch.ones((20, 12), device="cuda"),
                                 torch.ones((12, 8), device="cuda"))
