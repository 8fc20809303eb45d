"""The port's evaluator against ``shapley_vit_tpu.fl.evaluation``.

The coalition evaluator's ``[C, 2]`` (accuracy, mean loss) rows on the same
weight matrix and batches agree at 1e-5, chunked or not; the NaN guard
raises as the JAX one does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapley_vit_tpu.fl import evaluation as jev
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.fl import evaluation as tev
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm


def _coalition_setup():
    spec_j, spec_t = jvit.make_spec("micro"), tvit.make_spec("micro")
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec_j))
    lora = jax.device_get(jvit.init_lora(jax.random.key(1), spec_j, classifier_from=base))
    rng = np.random.default_rng(0)
    # deltas large enough that the coalitions' argmax accuracies differ
    deltas = [jax.tree.map(lambda a: 0.5 * rng.normal(size=a.shape).astype(np.float32), lora)
              for _ in range(3)]
    coalitions = [[0], [1], [2], [0, 1], [1, 2], [0, 2], [0, 1, 2]]
    W = jtm.coalition_weight_matrix(coalitions, [120, 300, 580], 3)
    images = rng.normal(size=(40, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=40).astype(np.int32)
    return spec_j, spec_t, base, lora, deltas, W, images, labels


@pytest.mark.parametrize("chunk", [0, 3])
def test_coalition_evaluator_matches_jax(chunk):
    spec_j, spec_t, base, lora, deltas, W, images, labels = _coalition_setup()
    j_eval = jev.make_coalition_evaluator(
        lambda b, m, x: jvit.vit_forward_merged(b, m, x, spec_j), coalition_chunk=chunk)
    merged_j = jvit.merge_coalition_weights(
        base, jtm.materialize_coalitions(lora, jtm.tree_stack(deltas), W), spec_j)
    j_batches = [(images[i:i + 16], labels[i:i + 16]) for i in range(0, 40, 16)]
    want = j_eval(base, merged_j, j_batches, dataset_size=40)

    t_eval = tev.make_coalition_evaluator(
        lambda b, m, x: tvit.vit_forward_merged(b, m, x, spec_t), coalition_chunk=chunk)
    tb = tree_from_numpy(base)
    merged_t = tvit.merge_coalition_weights(
        tb, ttm.materialize_coalitions(tree_from_numpy(lora),
                                       tree_from_numpy(ttm.tree_stack_host(deltas)), W), spec_t)
    t_batches = [(torch.tensor(x), torch.tensor(y)) for x, y in j_batches]
    got = t_eval(tb, merged_t, iter(t_batches), dataset_size=40)  # a one-shot stream
    assert got.shape == (7, 2)
    assert len(set(np.round(got[:, 0], 6))) > 1  # the accuracies differ across coalitions
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_single_model_paths_agree():
    """``evaluate_model`` and the backend's C=1 stack give the same numbers
    as the JAX package's ``evaluate_model``."""
    spec_j, spec_t, base, lora, deltas, _, images, labels = _coalition_setup()
    client = jax.tree.map(lambda a, d: a + d, lora, deltas[0])
    j_batches = [(images[i:i + 16], labels[i:i + 16]) for i in range(0, 40, 16)]
    want = jev.evaluate_model(lambda p, x: jvit.vit_forward(p[0], p[1], x, spec_j),
                              (base, client), j_batches)
    tb, tc = tree_from_numpy(base), tree_from_numpy(client)
    t_batches = [(torch.tensor(x), torch.tensor(y)) for x, y in j_batches]
    got = tev.evaluate_model(lambda p, x: tvit.vit_forward(p[0], p[1], x, spec_t), (tb, tc),
                             t_batches)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    backend = tev.EvalBackend(lambda b, l, x: tvit.vit_forward_coalitions(b, l, x, spec_t),
                              device="cpu")
    from shapley_vit_tpu_torch.data.arrays import ArrayDataset

    data = backend.device_batches(ArrayDataset(images=images, labels=labels), 16)
    assert [len(y) for _, y in data] == [16, 16, 8] and data[0][1].dtype == torch.long
    np.testing.assert_allclose(backend.evaluate_single(tb, tc, data), want, atol=1e-5, rtol=0)


def test_eval_step_metrics_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 32, 4)).astype(np.float32)
    logits[:, :8] = 0.25  # ties: both frameworks take the first maximum
    labels = rng.integers(0, 4, size=32).astype(np.int32)
    got_c, got_l = tev.eval_step_metrics(torch.tensor(logits), torch.tensor(labels))
    for c in range(3):
        want_c, want_l = jev.eval_step_metrics(jnp.asarray(logits[c]), jnp.asarray(labels))
        assert float(got_c[c]) == float(want_c)
        np.testing.assert_allclose(float(got_l[c]), float(want_l), rtol=1e-6)


def test_nan_guard_names_the_coalitions():
    def fwd(shared, varying, images):
        out = torch.zeros((varying["w"].shape[0], images.shape[0], 4))
        out[varying["w"] == 1] = float("nan")  # coalition 1, whichever chunk it is in
        return out

    evaluate = tev.make_coalition_evaluator(fwd, coalition_chunk=2)
    batches = [(torch.zeros((5, 2, 2, 3)), torch.zeros(5, dtype=torch.long))]
    with pytest.raises(FloatingPointError, match=r"coalitions \[1\]"):
        evaluate(None, {"w": torch.arange(3.0)}, batches)
    with pytest.raises(FloatingPointError):
        tev.evaluate_model(lambda p, x: torch.full((x.shape[0], 4), float("nan")), None, batches)


def test_suggest_coalition_chunk_matches_jax_formula():
    for hbm in (16e9, 80e9):
        assert tev.suggest_coalition_chunk(197, 768, 128, mem_bytes=hbm) == \
            jev.suggest_coalition_chunk(197, 768, 128, hbm_bytes=hbm)
    assert tev.suggest_coalition_chunk(197, 768, 128, device="cpu") >= 1
