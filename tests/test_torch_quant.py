"""The port's dynamic int8 (W8A8) evaluation against the JAX package's.

``ops/quant.py``: codes and scales identical to ``shapley_vit_tpu.ops.quant``
at float32 and from bfloat16 inputs; ``dynamic_int8_dense`` bit-identical
(float32). The micro ViT at ``quant="int8"``: logits against the JAX
forward (overlay and the merged three-coalition forward, which JAX
``vmap``s), with the fused MLP's int8 bypass against JAX's Pallas MLP in
interpret mode; ``start()`` at int8, Shapley values within 1e-4 of JAX's.

Logits tolerance, 1e-4: both packages round the same float32 values to the
same codes, so they agree to float32 rounding (measured below 1e-6). Where
a float32 difference in an upstream sum lands a value on the other side of
a rounding boundary, that one code moves by one step, which moves a logit
by about one activation scale times one weight scale (≈ 1e-5 at these
widths), well inside the bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.config import Config as JConfig
from shapley_vit_tpu.driver import start as jstart
from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import quant as jquant
from shapley_vit_tpu_torch.config import Config as TConfig
from shapley_vit_tpu_torch.driver import start as tstart
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import quant as tquant

LOGITS_ATOL = 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((8, 64), -1), ((3, 17, 48), -1), ((96, 40), 0)])
def test_quantize_symmetric_matches_jax(shape, axis, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 3.0, size=shape[-1])).astype(np.float32)
    x[0] = 0.0  # an all-zero row: scale 1e-12/127, codes 0
    xj = jnp.asarray(x, dtype=jnp.dtype(dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    qj, sj = jquant.quantize_symmetric(xj, axis=axis)
    qt, st = tquant.quantize_symmetric(xt, dim=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rounds_half_to_even():
    # 127 / 254 · {1, 3, 5}: exact halves after the scale, as jnp.round does
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = tquant.quantize_symmetric(x, dim=-1)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


@pytest.mark.parametrize("rows", [3, 16, 17, 197])
def test_dynamic_int8_dense_matches_jax(rows):
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(2, rows, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 128)) * 0.05).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    want = np.asarray(jquant.dynamic_int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tquant.dynamic_int8_dense(torch.tensor(x), torch.tensor(w), torch.tensor(b)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # same codes and scales, so the int32 sums and the float32 rescale agree
    np.testing.assert_array_equal(got, want)


def test_per_coalition_int8_dense_matches_jax_vmap():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 40, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 32, 24)) * 0.1).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    want = np.asarray(jax.vmap(lambda xi, wi: jquant.dynamic_int8_dense(xi, wi, jnp.asarray(b)))(
        jnp.asarray(x), jnp.asarray(w)))
    got = tquant.dynamic_int8_dense(torch.tensor(x), torch.tensor(w), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_int8_product_accumulates_exactly():
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (5, 3072), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (3072, 16), generator=gen, dtype=torch.int8)
    calls = tquant.int8_matmul.calls
    acc = tquant.int8_matmul(a, b)
    assert acc.dtype == torch.int32 and acc.shape == (5, 16)
    assert torch.equal(acc, (a.long() @ b.long()).int())
    assert tquant.int8_matmul.calls == calls + 1


def test_dense_zero_rows_no_nan():
    out = tquant.dynamic_int8_dense(torch.zeros((3, 16)), torch.ones((16, 8)))
    assert torch.isfinite(out).all() and torch.equal(out, torch.zeros((3, 8)))


@pytest.mark.parametrize("rows,K,N", [(20, 12, 8), (20, 16, 6), (5, 588, 24)])
def test_int8_dense_at_any_k_and_n_matches_jax(rows, K, N):
    """K and N off the multiples of 8 that ``_int_mm`` needs are padded with
    zero codes (K = 588: a patch of 14 at 3 channels), bit-identical to
    JAX's ``dot_general``."""
    rng = np.random.default_rng(K + N)
    x = rng.normal(size=(rows, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    want = np.asarray(jquant.dynamic_int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tquant.dynamic_int8_dense(torch.tensor(x), torch.tensor(w), torch.tensor(b)).numpy()
    assert got.shape == (rows, N)
    np.testing.assert_array_equal(got, want)


def test_int8_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="overflow"):
        tquant.int8_matmul(torch.ones((20, 133_152), dtype=torch.int8),
                           torch.ones((133_152, 8), dtype=torch.int8))


# ---------------------------------------------------------------------------
# the quantized ViT
# ---------------------------------------------------------------------------

TARGETS = {"int8_targets": jvit.INT8_TARGETS, "all_but_patch": ("q", "k", "v", "out", "fc1", "fc2"),
           "jax_default": jvit.ViTSpec().quant_targets}


@pytest.fixture(scope="module")
def micro():
    spec_j = jvit.make_spec("micro", num_classes=4)
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    rng = np.random.default_rng(3)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        lora)
    images = rng.normal(size=(16, spec_j.image, spec_j.image, 3)).astype(np.float32)
    return spec_j, base, lora, images


def _specs(targets, **port):
    spec_j = jvit.make_spec("micro", num_classes=4, quant="int8", quant_targets=targets)
    spec_t = tvit.make_spec("micro", num_classes=4, quant="int8", quant_targets=targets, **port)
    return spec_j, spec_t


@pytest.mark.parametrize("targets", list(TARGETS))
def test_quantized_forward_matches_jax(micro, targets):
    _, base, lora, images = micro
    spec_j, spec_t = _specs(TARGETS[targets], mlp_impl="xla")
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_j))
    calls = tquant.int8_matmul.calls
    got = tvit.vit_forward(tree_from_numpy(base), tree_from_numpy(lora), torch.tensor(images),
                           spec_t).numpy()
    # one product per quantized dense layer per block (q and v per coalition:
    # C = 1), and one for the patch projection
    blocks = [t for t in TARGETS[targets] if t != "patch"]
    patch = len(TARGETS[targets]) - len(blocks)
    assert tquant.int8_matmul.calls - calls == spec_t.depth * len(blocks) + patch
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)
    exact = np.asarray(jvit.vit_forward(base, lora, images, spec_j.replace(quant="none")))
    assert np.abs(got - exact).max() > 1e-5  # int8 really ran


def test_quantized_merged_coalition_forward_matches_jax(micro):
    """C = 3 coalitions, merged q/v kernels quantized per coalition (JAX:
    ``vmap`` of ``vit_forward_merged``)."""
    _, base, lora, images = micro
    spec_j, spec_t = _specs(jvit.INT8_TARGETS, mlp_impl="xla")
    stacked = jax.tree.map(lambda l: np.stack([l, 0.5 * l, -0.25 * l]), lora)
    merged_j = jvit.merge_coalition_weights(base, stacked, spec_j)
    want = np.asarray(jax.vmap(lambda m: jvit.vit_forward_merged(base, m, images, spec_j))(merged_j))
    tb = tree_from_numpy(base)
    merged_t = tvit.merge_coalition_weights(tb, tree_from_numpy(stacked), spec_t)
    calls = tquant.int8_matmul.calls
    got = tvit.vit_forward_merged(tb, merged_t, torch.tensor(images), spec_t).numpy()
    # q and v: one product per coalition; k and fc1 fold the coalitions into rows
    assert tquant.int8_matmul.calls - calls == spec_t.depth * (2 * 3 + 2)
    assert got.shape == (3, 16, 4)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def test_fused_mlp_bypasses_int8_as_jax_pallas_does(micro, monkeypatch):
    """``mlp_impl="pallas"`` keeps fc1 and fc2 out of int8 in both packages
    (JAX: the Pallas MLP in interpret mode; the port: the fused MLP's plain
    version on the CPU)."""
    monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
    _, base, lora, images = micro
    spec_j, spec_t = _specs(jvit.INT8_TARGETS, mlp_impl="pallas")
    spec_j = spec_j.replace(mlp_impl="pallas")
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_j))
    calls = tquant.int8_matmul.calls
    got = tvit.vit_forward(tree_from_numpy(base), tree_from_numpy(lora), torch.tensor(images),
                           spec_t).numpy()
    assert tquant.int8_matmul.calls - calls == spec_t.depth * 3  # q, k, v; not fc1
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the driver at int8
# ---------------------------------------------------------------------------

def _cfg(cls, out_dir):
    cfg = cls()
    cfg.model.vit_variant = "micro"
    cfg.model.compute_dtype = "float32"
    cfg.model.quant = "int8"
    cfg.data.synthetic_scale = 0.1
    cfg.data.eval_batch_size = 16
    cfg.obs.exp_dir = str(out_dir)
    cfg.dist.mesh = "off"
    return cfg


def test_build_model_at_int8_runs_the_torch_op_mlp():
    cfg = _cfg(TConfig, "unused")
    spec = tstart.build_model(cfg, device="cpu")[0]
    assert spec.quant == "int8" and spec.quant_targets == tvit.INT8_TARGETS
    assert spec.mlp_impl == "xla"
    cfg.model.quant = "none"
    assert tstart.build_model(cfg, device="cpu")[0].mlp_impl == "pallas"


def test_start_at_int8_matches_jax(tmp_path):
    jcfg = _cfg(JConfig, tmp_path / "jax")
    spec_j, base, lora = jstart.build_model(jcfg)
    base, lora = jax.device_get(base), jax.device_get(lora)
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((120, 300, 580)):
        drop = jax.tree.map(lambda a: a + 0.5 * rng.normal(size=a.shape).astype(np.float32), lora)
        p = str(tmp_path / f"client_{i + 1}_model" / "ViT_epoch_9.npz")
        jing.save_lora_checkpoint(p, drop, spec_j, num_local_data_train=n)
        paths.append(p)
    valid_j = jstart.load_validation_dataset(jcfg, target_size=spec_j.image)
    sv_j, _ = jstart.get_initial_shapley_value(jcfg, valid_j, spec_j, base, lora,
                                               checkpoint_paths=paths)

    tcfg = _cfg(TConfig, tmp_path / "torch")
    spec_t = tstart.build_model(tcfg, device="cpu")[0]
    valid_t = tstart.load_validation_dataset(tcfg, target_size=spec_t.image)
    calls = tquant.int8_matmul.calls
    sv_t, _ = tstart.get_initial_shapley_value(
        tcfg, valid_t, spec_t, tree_from_numpy(base), tree_from_numpy(lora),
        checkpoint_paths=paths, device="cpu")
    assert tquant.int8_matmul.calls > calls
    got = np.array([[sv_t[d][1][c] for c in range(3)] for d in (0, 1)])
    want = np.array([[sv_j[d][1][c] for c in range(3)] for d in (0, 1)])
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert os.path.exists(os.path.join(tcfg.output_dir, "utility_table.npz"))
