"""The port's ViT against ``shapley_vit_tpu.models.vit`` at float32.

Weights come from the JAX package's ``init_vit``/``init_lora`` and carry
over through numpy (``tree_from_numpy``). The JAX side runs both its default
XLA path and its Pallas kernels (``attention_impl="pallas2"``,
``mlp_impl``/``patch_impl="pallas"``) under the Pallas interpreter. Logits
agree at atol 2e-5.
"""

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm
from torch_one_thread import one_torch_thread  # noqa: F401

VARIANTS = {
    "micro": {},
    # 2 layers, width 64, 4 heads, patch 4
    "narrow2": dict(hidden=64, depth=2, heads=4, mlp_dim=128, patch=4, image=16),
}
JAX_PATHS = {
    "xla": {},
    "pallas": dict(attention_impl="pallas2", mlp_impl="pallas", patch_impl="pallas"),
}


def _setup(variant, seed=0):
    over = VARIANTS[variant]
    base_variant = "micro"
    spec_j = jvit.make_spec(base_variant, **over)
    spec_t = tvit.make_spec(base_variant, **over)
    base = jvit.init_vit(jax.random.key(seed), spec_j)
    lora = jvit.init_lora(jax.random.key(seed + 1), spec_j, classifier_from=base)
    rng = np.random.default_rng(seed)
    # a non-trivial overlay: B is zero at init
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                        jax.device_get(lora))
    images = rng.normal(size=(3, spec_j.image, spec_j.image, 3)).astype(np.float32)
    return spec_j, spec_t, jax.device_get(base), lora, images, rng


@pytest.mark.parametrize("jax_path", list(JAX_PATHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vit_forward_matches_jax(variant, jax_path, monkeypatch):
    spec_j, spec_t, base, lora, images, _ = _setup(variant)
    if JAX_PATHS[jax_path]:
        monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
        spec_j = spec_j.replace(**JAX_PATHS[jax_path])
    tb, tl = tree_from_numpy(base), tree_from_numpy(lora)
    x = torch.tensor(images)
    for jl, tl_ in ((lora, tl), (None, None)):
        want = np.asarray(jvit.vit_forward(base, jl, images, spec_j))
        got = tvit.vit_forward(tb, tl_, x, spec_t).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("jax_path", list(JAX_PATHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_merged_coalition_forward_matches_jax(variant, jax_path, monkeypatch):
    spec_j, spec_t, base, lora, images, rng = _setup(variant, seed=3)
    if JAX_PATHS[jax_path]:
        monkeypatch.setenv("SVT_PALLAS_INTERPRET", "1")
        spec_j = spec_j.replace(**JAX_PATHS[jax_path])
    deltas = [jax.tree.map(lambda a: 0.05 * rng.normal(size=a.shape).astype(np.float32), lora)
              for _ in range(3)]
    W = jtm.coalition_weight_matrix([[0], [1, 2], [0, 1, 2], []], [120, 300, 580], 3)
    merged_j = jvit.merge_coalition_weights(
        base, jtm.materialize_coalitions(lora, jtm.tree_stack(deltas), W), spec_j)
    want = np.asarray(jax.vmap(lambda m: jvit.vit_forward_merged(base, m, images, spec_j))(merged_j))

    tb = tree_from_numpy(base)
    stacked = tree_from_numpy(ttm.tree_stack_host(deltas))
    merged_t = tvit.merge_coalition_weights(
        tb, ttm.materialize_coalitions(tree_from_numpy(lora), stacked, W), spec_t)
    for k in ("q_kernel", "v_kernel"):
        np.testing.assert_allclose(merged_t[k].numpy(), np.asarray(merged_j[k]), atol=1e-6, rtol=0)
    got = tvit.vit_forward_merged(tb, merged_t, torch.tensor(images), spec_t).numpy()
    assert got.shape == (4, 3, spec_t.num_classes)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    # overlay mode over the same coalitions: the same logits without the fold
    overlay = tvit.vit_forward_coalitions(
        tb, ttm.materialize_coalitions(tree_from_numpy(lora), stacked, W), torch.tensor(images),
        spec_t).numpy()
    np.testing.assert_allclose(overlay, got, atol=2e-5, rtol=0)


def test_merge_lora_and_tanh_gelu_match_jax():
    spec_j, spec_t, base, lora, images, _ = _setup("micro", seed=5)
    got = tvit.merge_lora(tree_from_numpy(base), tree_from_numpy(lora), spec_t)
    want = jvit.merge_lora(base, lora, spec_j)
    for a, b in zip(ttm.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    spec_jt, spec_tt = spec_j.replace(gelu="tanh"), spec_t.replace(gelu="tanh")
    want = np.asarray(jvit.vit_forward(base, lora, images, spec_jt))
    got = tvit.vit_forward(tree_from_numpy(base), tree_from_numpy(lora), torch.tensor(images),
                           spec_tt).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_init_matches_jax_layout_and_distributions():
    spec = tvit.make_spec("micro")
    gen = torch.Generator().manual_seed(0)
    base = tvit.init_vit(gen, spec)
    lora = tvit.init_lora(gen, spec, classifier_from=base)
    spec_j = jvit.make_spec("micro")
    jbase = jvit.init_vit(jax.random.key(0), spec_j)
    jlora = jvit.init_lora(jax.random.key(1), spec_j, classifier_from=jbase)
    for t, j in ((base, jbase), (lora, jlora)):
        assert [tuple(a.shape) for a in ttm.tree_leaves(t)] == [a.shape for a in jax.tree.leaves(j)]
    k = base["blocks"]["attn"]["q"]["kernel"]
    assert float(k.abs().max()) <= 0.04 and 0.01 < float(k.std()) < 0.02
    assert float(lora["lora"]["q"]["A"].abs().max()) <= (1 / spec.hidden) ** 0.5
    assert float(lora["lora"]["q"]["B"].abs().max()) == 0.0
    assert tvit.trainable_params(lora) == sum(a.size for a in jax.tree.leaves(jlora))
