"""The plain reference against the program at a tiny size, in float32 on
the CPU: the coalition forward, the coalitions' utilities, the Shapley
scoring and the client's Adam steps."""

import numpy as np
import pytest
import torch

from bench_port.lib import inputs
from bench_port.references import vit as ref
from conftest import tiny_context


def _f32(ctx):
    ctx.config["compute_dtype"] = "float32"
    return ctx


def _inputs(ctx, n=3):
    dev = ctx.devices[0]
    fam = ctx.family()
    d = fam.dims(ctx.config)
    gen = inputs.generator(ctx.seed, dev)
    base = fam.base(ctx.config, gen, dev)
    init = inputs.init_overlay(d, base, gen, dev)
    images, labels = inputs.images(d, ctx.config["validation_images"], gen, dev, 4)
    deltas = inputs.client_deltas(d, n, gen, dev, ctx.mix.get(
        "delta_scale", {"A": 0.02, "B": 0.1, "classifier": 0.05}))
    return base, init, images, labels, deltas


def test_forward_matches_program_float32():
    ctx = _f32(tiny_context("vitb16-n3"))
    base, init, images, labels, deltas = _inputs(ctx)
    forward = ctx.family().forward(ctx.family().spec(ctx.config))
    ov = ref.mix_overlay(init, deltas, np.array([0.2, 0.3, 0.5]), "cpu")
    folded = ref.fold(base, ov, ctx.config)
    head = {"kernel": ov["classifier.kernel"], "bias": ov["classifier.bias"]}
    want = ref.forward(base, images, ctx.config, q_kernel=folded["q"], v_kernel=folded["v"], head=head)
    tree = ref._nest(ov)
    with torch.no_grad():
        got = forward(base, tree, images)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5), (got - want).abs().max()


def test_coalition_utilities_match_program_float32():
    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.data.arrays import ArrayDataset
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.models.convert import tree_from_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm

    ctx = _f32(tiny_context("vitb16-n3"))
    base, init, images, labels, deltas = _inputs(ctx)
    sizes = [120.0, 300.0, 580.0]
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.data.eval_batch_size = 16
    spec = ctx.family().spec(ctx.config)
    backend, eval_coalitions, _ = drv.build_eval_backend(cfg, spec, base, init, device="cpu",
                                                         devices=[torch.device("cpu")])
    data = backend.device_batches(ArrayDataset(images=images.numpy(), labels=labels.numpy()), 16)
    coalitions = [(0,), (1, 2), (0, 1, 2)]
    W = tm.coalition_weight_matrix(coalitions, sizes, 3)
    stacked = tree_from_numpy(tm.tree_stack_host(deltas), "cpu")
    got = eval_coalitions(init, stacked, W, data, dataset_size=len(labels))
    want = ref.coalition_utilities(base, init, deltas, sizes, images, labels, ctx.config, block=16)
    for row, members in zip(got, coalitions):
        np.testing.assert_allclose(row, want[frozenset(members)], atol=1e-5)


@pytest.mark.parametrize("n", [3, 5])
def test_comp_contrib_matches_program_estimator(n):
    from shapley_vit_tpu_torch.shapley import TabularGame
    from shapley_vit_tpu_torch.shapley.estimators import shapley_comp_contrib

    rng = np.random.default_rng(n)
    table = {}
    for r in range(1, n + 1):
        import itertools

        for c in itertools.combinations(range(n), r):
            table[frozenset(c)] = rng.normal(size=2)
    prev = np.array([0.3, 1.2])
    game = TabularGame({k: v + prev for k, v in table.items()}, n_all=n, previous_utility=list(prev))
    sv = shapley_comp_contrib(game, 50 * n, rng=np.random.default_rng(7))
    absolute = {k: v + prev for k, v in table.items()}
    absolute[frozenset()] = prev
    want = ref.comp_contrib(n, 50 * n, absolute, np.random.default_rng(7))
    got = np.array([[sv[d][c] for c in range(n)] for d in range(2)])
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_train_steps_match_program_float32():
    from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
    from shapley_vit_tpu_torch.fl import training as tr

    ctx = _f32(tiny_context("vitb16-train-b64"))
    base, init, images, labels, _ = _inputs(ctx)
    fam = ctx.family()
    step = tr.make_train_step(fam.forward(fam.spec(ctx.config, **TRAIN_SPEC)), 4)
    lora = tr.trainable(init)
    opt = tr.adam(5e-3)
    state = opt.init(lora)
    rows = [torch.arange(i * 8, (i + 1) * 8) for i in range(3)]
    losses = []
    first = None
    for i, idx in enumerate(rows):
        lora, state, loss = step(base, lora, state, images[idx], labels[idx], None)
        losses.append(float(loss))
        if i == 0:
            first = {k: state.state[ref.leaf(lora, k)]["exp_avg"] / 0.1 for k in ref.LEAVES}
    want_losses, want_grad, want_change, moving = ref.train_steps(base, init, images, labels, rows,
                                                                  ctx.config, 5e-3)
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    for k in ref.LEAVES:
        np.testing.assert_allclose(first[k].numpy(), want_grad[k].numpy(), atol=1e-5)
        change = ref.leaf(lora, k).detach() - ref.leaf(init, k)
        np.testing.assert_allclose(change.numpy(), want_change[k].numpy(), atol=1e-4)
    # B starts at zero, so A's first gradient is zero; the B leaves and the
    # head move from the first step
    assert {"classifier.bias", "classifier.kernel", "lora.q.B", "lora.v.B"} <= set(moving)
    assert float(want_grad["lora.q.A"].norm()) == 0.0
