"""The port's tree algebra against ``shapley_vit_tpu.ops.tree_math`` (1e-6)."""

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.models.convert import tree_from_numpy, tree_to_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm
from torch_one_thread import one_torch_thread  # noqa: F401


def _lora_deltas(n, seed=0):
    spec = jvit.make_spec("micro")
    base = jvit.init_vit(jax.random.key(0), spec)
    init = jax.device_get(jvit.init_lora(jax.random.key(1), spec, classifier_from=base))
    rng = np.random.default_rng(seed)
    deltas = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), init)
              for _ in range(n)]
    return init, deltas


def _assert_trees_close(got, want, atol=1e-6):
    got, want = tree_to_numpy(got), jax.device_get(want)
    assert [np.shape(a) for a in ttm.tree_leaves(got)] == [np.shape(a) for a in jax.tree.leaves(want)]
    for a, b in zip(ttm.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def test_tree_leaves_follow_jax_order():
    init, _ = _lora_deltas(1)
    t = tree_from_numpy(init)
    for a, b in zip(ttm.tree_leaves(t), jax.tree.leaves(init)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("coalitions", [[[0], [1, 2], [0, 1, 2], []], [[2], [0, 2]]])
def test_coalition_weight_matrix_and_materialize_match_jax(coalitions):
    init, deltas = _lora_deltas(3)
    sizes = [120, 300, 580]
    W = ttm.coalition_weight_matrix(coalitions, sizes, 3)
    np.testing.assert_array_equal(W, jtm.coalition_weight_matrix(coalitions, sizes, 3))
    stacked_j = jtm.tree_stack(deltas)
    want = jtm.materialize_coalitions(init, stacked_j, W)
    stacked_t = tree_from_numpy(ttm.tree_stack_host(deltas))
    got = ttm.materialize_coalitions(tree_from_numpy(init), stacked_t, W)
    _assert_trees_close(got, want)
    # the empty coalition reproduces the initial overlay exactly
    if [] in coalitions:
        row = coalitions.index([])
        for a, b in zip(ttm.tree_leaves(got), jax.tree.leaves(init)):
            np.testing.assert_array_equal(a[row].numpy(), np.asarray(b))


def test_aggregate_and_apply_deltas_match_jax():
    init, deltas = _lora_deltas(3, seed=1)
    ratio = jtm.fedavg_ratio([1, 2, 5])
    np.testing.assert_array_equal(ttm.fedavg_ratio([1, 2, 5]), ratio)
    want = jtm.apply_deltas(init, jtm.aggregate_deltas(jtm.tree_stack(deltas), ratio))
    t_stacked = ttm.tree_stack([tree_from_numpy(d) for d in deltas])
    got = ttm.apply_deltas(tree_from_numpy(init), ttm.aggregate_deltas(t_stacked, ratio))
    _assert_trees_close(got, want)
    assert ttm.tree_allclose(got, tree_from_numpy(jax.device_get(want)))
    assert not ttm.tree_allclose(got, tree_from_numpy(init))
    unstacked = ttm.tree_unstack(t_stacked)
    assert ttm.tree_allclose(unstacked[2], tree_from_numpy(deltas[2]), atol=0, rtol=0)
    with pytest.raises(ValueError):
        ttm.fedavg_ratio([0, 0])


def test_materialize_is_float32_exact_against_float64():
    """TF32 stays off: the mixing is float32 to the last bits (1e-6)."""
    init, deltas = _lora_deltas(4, seed=2)
    W = np.random.default_rng(0).random((6, 4)).astype(np.float32)
    got = ttm.materialize_coalitions(tree_from_numpy(init),
                                     tree_from_numpy(ttm.tree_stack_host(deltas)), W)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    for g, i, d in zip(ttm.tree_leaves(got), jax.tree.leaves(init),
                       ttm.tree_leaves(ttm.tree_stack_host(deltas))):
        want = np.asarray(i, np.float64)[None] + np.tensordot(W.astype(np.float64), d, axes=(1, 0))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6, rtol=1e-6)
