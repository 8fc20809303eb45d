"""The port at the widths of the tiny and micro ViTs, against the JAX package.

The card's kernels take these widths (the MLP's tensor-core routes any D and
hidden width, zero-padded to multiples of 8 (bf16) or 4 (float32); attention
head dims under 64 zero-padded to 64), so the CPU checks what the card's
wrappers do around the kernels at those widths:

* the plain fused MLP (what a CPU tensor runs and what the card holds the
  kernels against) against the JAX Pallas kernel run by the interpreter, at
  D = 32 (micro) and 192 (tiny), float32 (atol 1e-5) and bfloat16 (one bf16
  step at the larger magnitude, at least 1: both round y and h to bf16 and
  then the output, and a float32 sum taken in another order can carry a
  value across a rounding boundary);
* the head-dim padding of the attention wrappers (``resize_heads``), run
  through the plain attention with the true head dim's scale, against the
  JAX kernels at d = 16, 32 (padded to 64), 80 and 128 (padded to or run at
  128) and N up to 257, and at d = 136, 256, 384 and 512 (136 padded to
  192, the others run as they are; the JAX wrappers pad to a multiple of
  128) (float32, atol 1e-5);
* the MLP wrapper's zero padding of D and the hidden width
  (``pad_widths``), run through the plain MLP with the LN statistics over
  the true D and cut back, against the unpadded plain MLP (float32, atol
  1e-6);
* which MLP kernel a call would take on the card (``mlp_route``), which
  attention kernel (``attention_route``), which patch-embedding kernel
  (``ROUTE``), and which head dims the attention wrappers take;
* a depth-2 tiny ViT against the JAX ViT at float32 (atol 2e-5, the house
  bar of test_vit_parity.py), and depth-2 ViTs at N = 257 (256 px) and at
  head dims 96 and 192.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import attention as jatt
from shapley_vit_tpu.ops.mlp_block import fused_mlp_block as j_mlp
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import attention as tatt
from shapley_vit_tpu_torch.ops import mlp_block as tmlp
from shapley_vit_tpu_torch.ops import patch_embed as tpe


def _np(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _mlp_args(rng, M, D, Hd):
    return (_np(rng, (M, D)), 1 + _np(rng, (D,), 0.1), _np(rng, (D,), 0.1),
            _np(rng, (D, Hd), 0.05), _np(rng, (Hd,), 0.1), _np(rng, (Hd, D), 0.05),
            _np(rng, (D,), 0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("M", [33, 197])
@pytest.mark.parametrize("D", [32, 192])
def test_mlp_at_micro_and_tiny_widths_matches_pallas(D, M, approximate, dtype):
    rng = np.random.default_rng(D + M)
    args = _mlp_args(rng, M, D, 4 * D)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = tmlp.fused_mlp_block.launches
    got = tmlp.fused_mlp_block(*(torch.tensor(a).to(tdt) for a in args), eps=1e-12,
                               approximate_gelu=approximate)
    assert tmlp.fused_mlp_block.launches == before and got.dtype == tdt
    want = np.asarray(j_mlp(*(jnp.asarray(a, dtype=jdt) for a in args), eps=1e-12,
                            block_rows=64, interpret=True, approximate_gelu=approximate),
                      dtype=np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        _, e = np.frexp(np.maximum(np.maximum(np.abs(got), np.abs(want)), 1.0))
        step = np.ldexp(1.0, e - 8)  # bf16: 8 significant bits
        assert np.all(np.abs(got - want) <= step)


@pytest.mark.parametrize("N,d", [*((N, d) for N in (197, 50, 257) for d in (16, 32, 80, 128)),
                                 (50, 136), (50, 256), (50, 384), (17, 512)])
def test_padded_head_dims_match_pallas(d, N, monkeypatch):
    """What the card's wrappers launch for a head dim the kernels do not
    take: q/k/v zero-padded per head to 64, 128 or, past 128, a multiple of
    64 (136 to 192), the kernel's arithmetic (the plain version) at the true
    head dim's scale, the output cut back; 128, 256, 384 and 512 run as
    they are. N = 257 is past the 224 keys of the main paths' bf16
    tensor-core route."""
    B, H = 2, 3
    rng = np.random.default_rng(d + N)
    q, k, v = (_np(rng, (B, N, H * d)) for _ in range(3))
    dk = tatt.kernel_head_dim(d)
    assert dk == {16: 64, 32: 64, 80: 128, 128: 128, 136: 192, 256: 256, 384: 384, 512: 512}[d]
    scale = 1.0 / math.sqrt(d)

    padded = [tatt.resize_heads(torch.tensor(t), H, dk) for t in (q, k, v)]
    assert padded[0].shape == (B, N, H * dk)
    got = tatt.resize_heads(tatt.fused_attention_packed_plain(*padded, heads=H, scale=scale), H, d)
    want = np.asarray(jatt.fused_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                  heads=H, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")  # the JAX entry's Pallas kernel
    qh, kh, vh = (t.reshape(B, N, H, d).transpose(0, 2, 1, 3) for t in (q, k, v))
    padded = [tatt.resize_heads(torch.tensor(t), 1, dk) for t in (qh, kh, vh)]
    assert padded[0].shape == (B, H, N, dk)
    got = tatt.resize_heads(tatt.fused_attention_plain(*padded, scale=scale), 1, d)
    want = np.asarray(jatt.fused_attention(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_resize_heads_pads_with_zeros_and_cuts_back():
    t = torch.arange(2 * 3 * 2 * 16, dtype=torch.float32).reshape(2, 3, 2 * 16)
    p = tatt.resize_heads(t, 2, 64)
    heads = p.reshape(2, 3, 2, 64)
    assert torch.equal(heads[..., :16], t.reshape(2, 3, 2, 16))
    assert not heads[..., 16:].any()
    assert torch.equal(tatt.resize_heads(p, 2, 16), t)


@pytest.mark.parametrize("d,dk", [(8, 64), (16, 64), (32, 64), (56, 64), (64, 64), (12, 64),
                                  (4, 64), (1, 64), (72, 128), (80, 128), (96, 128), (128, 128),
                                  (136, 192), (256, 256), (320, 320), (0, None)])
def test_attention_head_dims_the_kernel_takes(d, dk):
    """Any head dim from 1 runs: up to 128 zero-padded to 64 or 128 (the
    key-loop tensor-core routes' widths), past 128 to a multiple of 64 (the
    wide tensor-core and FMA routes'), as the JAX wrappers pad d to a
    multiple of 128 with no cap; d < 1 is refused."""
    if dk is not None:
        assert tatt.kernel_head_dim(d) == dk
    else:
        with pytest.raises(ValueError, match="head dim"):
            tatt.kernel_head_dim(d)


def _offset(t, elements):
    """A contiguous copy of ``t`` that starts ``elements`` past an aligned
    allocation."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("D,Hd,dtype,offset,route", [
    (768, 3072, torch.bfloat16, 0, "wgmma"),   # base
    (192, 768, torch.bfloat16, 0, "wgmma"),    # tiny
    (32, 64, torch.bfloat16, 0, "wgmma"),      # micro
    (200, 808, torch.bfloat16, 0, "wgmma"),    # any multiple of 8
    (768, 3000, torch.bfloat16, 0, "wgmma"),
    (192, 768, torch.bfloat16, 1, "wgmma"),    # weights not 16-byte aligned: copied first
    (64, 100, torch.bfloat16, 0, "wgmma"),     # hidden width not a multiple of 8: padded
    (768, 3070, torch.bfloat16, 0, "wgmma"),
    (32, 64, torch.float32, 0, "tf32x3"),      # micro
    (192, 768, torch.float32, 0, "tf32x3"),    # tiny
    (768, 3072, torch.float32, 0, "tf32x3"),   # base
    (1024, 4096, torch.float32, 0, "tf32x3"),
    (200, 808, torch.float32, 0, "tf32x3"),    # any multiple of 4
    (1056, 64, torch.float32, 0, "tf32x3"),    # the GEMMs have no cap on D
    (192, 768, torch.float32, 1, "tf32x3"),    # weights not 16-byte aligned: copied first
    (200, 808, torch.float32, 1, "tf32x3"),    # ... whatever D
    (768, 3070, torch.float32, 0, "tf32x3"),   # hidden width not a multiple of 4: padded
    (36, 64, torch.bfloat16, 0, "wgmma"),      # D not a multiple of 8: padded
    (36, 66, torch.float32, 0, "tf32x3"),      # neither a multiple of 4: both padded
])
def test_mlp_route(D, Hd, dtype, offset, route):
    """Every width and alignment takes the dtype's tensor-core route: the
    wrapper pads widths (``pad_widths``) and copies unaligned weights."""
    x = torch.zeros((3, D), dtype=dtype)
    w1 = _offset(torch.zeros((D, Hd), dtype=dtype), offset)
    w2 = _offset(torch.zeros((Hd, D), dtype=dtype), offset)
    assert tmlp.mlp_route(x, w1, w2) == route


@pytest.mark.parametrize("D", [36, 202, 1030])
@pytest.mark.parametrize("Hd", [66, 3070])
@pytest.mark.parametrize("multiple", [4, 8])
def test_mlp_padding_is_exact(D, Hd, multiple):
    """The card wrapper's zero padding of D and the hidden width, run
    through the plain MLP with the LN statistics over the true D and cut
    back to D, gives the unpadded plain MLP's output (float32, atol and
    rtol 1e-6: the padded columns add exact zeros, so only the order in
    which the CPU's BLAS takes the float32 sums over up to 3,070 terms at
    the padded shapes can move the outputs, whose magnitudes reach about 4,
    by a few of their last bits)."""
    rng = np.random.default_rng(D + Hd)
    x = torch.tensor(rng.normal(size=(5, D)), dtype=torch.float32)
    ls = torch.tensor(1 + 0.1 * rng.normal(size=D), dtype=torch.float32)
    lb, b2 = (torch.tensor(0.1 * rng.normal(size=D), dtype=torch.float32) for _ in range(2))
    w1 = torch.tensor(0.03 * rng.normal(size=(D, Hd)), dtype=torch.float32)
    b1 = torch.tensor(0.1 * rng.normal(size=Hd), dtype=torch.float32)
    w2 = torch.tensor(0.03 * rng.normal(size=(Hd, D)), dtype=torch.float32)
    args = (x, ls, lb, w1, b1, w2, b2)
    padded = tmlp.pad_widths(*args, multiple)
    Dp, Hp = padded[3].shape
    assert Dp % multiple == 0 and Hp % multiple == 0 and Dp - D < multiple and Hp - Hd < multiple
    assert padded[0].shape == (5, Dp) and padded[5].shape == (Hp, Dp)
    got = tmlp.fused_mlp_block_plain(*padded, ln_width=D)
    assert torch.equal(got[:, D:], x.new_zeros((5, Dp - D)))  # x + 0 past D, x being 0 there
    want = tmlp.fused_mlp_block_plain(*args)
    torch.testing.assert_close(got[:, :D], want, atol=1e-6, rtol=1e-6)


def test_patch_embed_runs_on_the_tensor_cores_in_both_dtypes():
    """The patch embedding's route on the card: bf16 on ``wgmma``, float32
    on ``tf32x3`` (3xTF32), at every shape; no FMA route is left."""
    assert tpe.ROUTE == {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


@pytest.mark.parametrize("dtype,N,d,route", [
    (torch.bfloat16, 197, 64, "wgmma"),      # the round and the training views
    (torch.bfloat16, 17, 64, "wgmma"),       # micro, padded to 64
    (torch.bfloat16, 1, 64, "wgmma"),
    (torch.bfloat16, 224, 64, "wgmma"),      # the longest it takes
    (torch.bfloat16, 225, 64, "wgmma_kl"),   # past 224 keys
    (torch.bfloat16, 257, 64, "wgmma_kl"),   # 256 px
    (torch.bfloat16, 577, 64, "wgmma_kl"),   # 384 px
    (torch.bfloat16, 17, 128, "wgmma_kl"),   # head dim 128 at any N
    (torch.bfloat16, 197, 128, "wgmma_kl"),
    (torch.bfloat16, 577, 128, "wgmma_kl"),
    (torch.bfloat16, 197, 256, "wgmma_wide"),  # past head dim 128
    (torch.bfloat16, 577, 192, "wgmma_wide"),
    (torch.bfloat16, 17, 512, "wgmma_wide"),   # the widest it takes
    (torch.bfloat16, 65, 320, "wgmma_wide"),
    (torch.bfloat16, 197, 576, "wgmma_stream"),  # past WIDE_MAX
    (torch.bfloat16, 17, 1024, "wgmma_stream"),  # no cap
    (torch.float32, 197, 64, "tf32x3"),      # the float32 round and training views
    (torch.float32, 17, 64, "tf32x3"),
    (torch.float32, 577, 64, "tf32x3"),      # 384 px: any N
    (torch.float32, 577, 128, "tf32x3"),     # and head dim 128
    (torch.float32, 197, 256, "tf32x3_wide"),  # past head dim 128
    (torch.float32, 65, 320, "tf32x3_wide"),
    (torch.float32, 197, 192, "tf32x3_wide"),  # the narrowest it takes
    (torch.float32, 197, 576, "tf32x3_wide"),  # past bf16's WIDE_MAX
    (torch.float32, 17, 1024, "tf32x3_wide"),  # no cap
])
def test_attention_route(dtype, N, d, route):
    """The kernel the attention entries launch on the card for a padded head
    dim d: for bf16 the main paths' tensor-core one at head dim 64 and
    N <= 224, the key-loop tensor-core one at any other N or head dim 128,
    the wide tensor-core one (128-column output panels) at head dims 192 to
    512 and any N, and the streamed one (Q and K streamed in panels of d)
    past 512; for float32 the float32 tensor-core one (3xTF32) up to head
    dim 128 at any N and the float32 wide tensor-core one (Q and K
    streamed in panels of d) at every head dim past 128. Where the tensors
    lie does not change the route: the wrappers copy what the TMA cannot
    read (``test_tma_readable``) before every launch."""
    assert tatt.attention_route(dtype, N, d) == route


@pytest.mark.parametrize("dtype,offset,strides,readable", [
    (torch.float32, 0, (197 * 768, 64, 768), True),
    (torch.float32, 1, (197 * 768, 64, 768), False),   # pointers not 16-byte aligned
    (torch.float32, 0, (17 * 132, 66, 132), False),    # strides not multiples of 4
    (torch.float32, 0, (3, 3, 64), True),              # strides of extent 1 unused
    (torch.bfloat16, 0, (197 * 768, 64, 768), True),
    (torch.bfloat16, 1, (197 * 768, 64, 768), False),  # pointers not 16-byte aligned
    (torch.bfloat16, 0, (17 * 132, 66, 132), False),   # strides not multiples of 8
    (torch.bfloat16, 0, (17 * 136, 68, 136), False),
])
def test_tma_readable(dtype, offset, strides, readable):
    """What the wrappers copy before a tensor-core launch: tensors whose
    pointers are not 16-byte aligned or whose strides are not multiples of
    16 bytes (4 float32, 8 bf16)."""
    t = _offset(torch.zeros(64, dtype=dtype), offset)
    B, H = (1, 1) if strides == (3, 3, 64) else (2, 2)
    assert tatt.tma_readable((t, t, t), B, H, strides) == readable


def test_wgmma_route_limit_is_the_kernel_s():
    """``WGMMA_MAX_SEQ``, the longest N the route sends the bf16 tensor-core
    kernel, is the kernel's own: MAX_KC chunks of KC keys in
    ``csrc/attention.cu``, whose entry refuses longer N."""
    src = (Path(tatt.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (MAX_KC|KC) = (\d+);", src)}
    assert consts["MAX_KC"] * consts["KC"] == tatt.WGMMA_MAX_SEQ


def test_wide_route_limit_is_the_kernel_s():
    """``WIDE_MAX``, the widest padded head dim the route sends the bf16
    wide tensor-core kernel, is the kernel's own in ``csrc/attention.cu``,
    whose entry refuses wider heads, and the route takes every multiple of
    ``WIDE_STEP`` from 192 up to it."""
    src = (Path(tatt.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    assert int(re.search(r"constexpr int WIDE_MAX = (\d+);", src).group(1)) == tatt.WIDE_MAX
    for d in range(192, tatt.WIDE_MAX + 1, tatt.WIDE_STEP):
        assert tatt.attention_route(torch.bfloat16, 197, d) == "wgmma_wide"
    assert tatt.attention_route(torch.bfloat16, 197, tatt.WIDE_MAX + tatt.WIDE_STEP) == "wgmma_stream"


def test_float32_wide_route_has_no_cap():
    """Every float32 head dim past 128 that the wrappers pad to (each
    multiple of ``WIDE_STEP`` from 192 to 2048) goes to the float32 wide
    tensor-core route, never to a bf16 one, and that route's entry in
    ``_FNS`` is defined in ``csrc/attention.cu`` (the card tests run it at
    head dim 1024)."""
    src = (Path(tatt.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    for d in range(192, 2048 + 1, tatt.WIDE_STEP):
        assert tatt.attention_route(torch.float32, 197, d) == "tf32x3_wide"
        assert tatt.attention_route(torch.float32, 17, d) == "tf32x3_wide"
    entry = f"svt_attention_bhnd_{tatt._ENTRY['tf32x3_wide']}"
    assert entry in tatt._FNS
    assert f"int {entry}(" in src


def test_wide_head_dim_step_is_the_stream_kernel_s():
    """``WIDE_STEP``, the multiple that head dims past 128 are padded to, is
    the bf16 streamed kernel's panel: the ``STREAM_DP`` columns of d it
    streams per stage in ``csrc/attention.cu``, whose entries refuse other
    head dims (the other wide tensor-core entries take the same multiples:
    64-column panels of the bf16 wide kernel, 64-column halves of the
    float32 one's output panels)."""
    src = (Path(tatt.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    assert int(re.search(r"constexpr int STREAM_DP = (\d+);", src).group(1)) == tatt.WIDE_STEP


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_tiny_depth2_forward_matches_jax(jax_path, monkeypatch):
    """A depth-2 tiny ViT (D 192, 3 heads of 64, MLP 768, 224 px) with a
    non-trivial LoRA overlay: the port against the JAX ViT on its XLA path
    and on its Pallas kernels (interpreter)."""
    over = dict(depth=2)
    spec_j = jvit.make_spec("tiny", **over)
    spec_t = tvit.make_spec("tiny", **over)
    if jax_path == "pallas":
        monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
        spec_j = spec_j.replace(attention_impl="pallas2", mlp_impl="pallas", patch_impl="pallas")
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base)
    rng = np.random.default_rng(0)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        jax.device_get(lora))
    images = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_j))
    got = tvit.vit_forward(tree_from_numpy(base), tree_from_numpy(lora), torch.tensor(images),
                           spec_t).numpy()
    assert got.shape == want.shape == (2, spec_t.num_classes)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", ["image256", "head_dim96", "head_dim192"])
def test_depth2_vit_past_224_keys_and_at_head_dim_96_matches_jax(case):
    """A depth-2 ViT with a non-trivial LoRA overlay where the card's
    attention runs past the main paths' bf16 tensor-core route's 224 keys
    (tiny at 256 px: N = 257), at a head dim that is padded to 128 (tiny
    with 2 heads of 96) or at one past 128 (tiny with 1 head of 192, the
    wide tensor-core routes' in bf16 and in float32): the
    port on the CPU against the JAX ViT's XLA path."""
    over = {"image256": dict(depth=2, image=256), "head_dim96": dict(depth=2, heads=2),
            "head_dim192": dict(depth=2, heads=1)}[case]
    spec_j = jvit.make_spec("tiny", **over)
    spec_t = tvit.make_spec("tiny", **over)
    assert (spec_t.image // spec_t.patch) ** 2 + 1 == (257 if case == "image256" else 197)
    assert spec_t.head_dim == {"image256": 64, "head_dim96": 96, "head_dim192": 192}[case]
    base = jax.device_get(jvit.init_vit(jax.random.key(2), spec_j))
    lora = jvit.init_lora(jax.random.key(3), spec_j, classifier_from=base)
    rng = np.random.default_rng(1)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        jax.device_get(lora))
    images = rng.normal(size=(2, spec_t.image, spec_t.image, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_j))
    got = tvit.vit_forward(tree_from_numpy(base), tree_from_numpy(lora), torch.tensor(images),
                           spec_t).numpy()
    assert got.shape == want.shape == (2, spec_t.num_classes)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
