"""The port's multi-round FL driver (``driver/rounds.py``) against the JAX
package's ``run_federated_rounds``, on the CPU.

The JAX test's setting (``tests/test_adversarial_rounds.py``): the micro
ViT (depth 2, 16 px) in float32, three clients of 16 seeded images, 24
validation images, 2 SGD 5e-2 steps per client and round, 3 rounds with
participation ``[[1,1,1],[1,0,1],[1,1,1]]`` and a MILP budget of 2. The
JAX side trains and evaluates through XLA (its default spec), the port
through the plain versions of its kernels (training under
``driver.client.TRAIN_SPEC``), from the same weights carried over as numpy.
Bars: per-round utilities within 1e-5, Shapley values within 1e-4 (the
house parity bar), the same rounds chosen.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from shapley_vit_tpu.driver import rounds as jrounds
from shapley_vit_tpu.fl import evaluation as jev
from shapley_vit_tpu.fl import training as jtr
from shapley_vit_tpu.models import vit as jvit
from shapley_vit_tpu.ops import tree_math as jtm
from shapley_vit_tpu_torch.driver import rounds as trounds
from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
from shapley_vit_tpu_torch.fl import evaluation as tev
from shapley_vit_tpu_torch.fl import training as ttr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.ops import tree_math as ttm
from shapley_vit_tpu_torch.shapley import call_shapley_computation_method, shapley_exact
from shapley_vit_tpu_torch.utils.profiling import StepTimer

PARTICIPATION = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], dtype=bool)
ESTIMATORS = ["exact", "comp_contrib", "gtg", "mr", "tmr"]


def _data():
    """The JAX test's data, drawn in its order from its seed."""
    rng = np.random.default_rng(0)
    clients = []
    for _ in range(3):
        X = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
        y = rng.integers(0, 4, 16)
        clients.append((X, y))
    val = (rng.normal(size=(24, 16, 16, 3)).astype(np.float32), rng.integers(0, 4, 24))
    return clients, val


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch runs this module's models on one thread: the micro ViT and the
    small images gain nothing from more, and the suite runs several workers
    on the same cores, where more threads each only wait on one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setting():
    spec = jvit.make_spec("micro")
    base = jax.device_get(jvit.init_vit(jax.random.key(0), spec))
    lora0 = jax.device_get(jvit.init_lora(jax.random.key(1), spec, classifier_from=base))
    clients, val = _data()
    return dict(base=base, lora0=lora0, clients=clients, val=val)


@pytest.fixture(scope="module")
def jax_runs(setting):
    """JAX's ``run_federated_rounds`` per estimator (budget 2), run once
    each and shared by the tests of this module."""
    spec = jvit.make_spec("micro")
    base, val_batches = setting["base"], [setting["val"]]
    opt = optax.sgd(5e-2)
    step = jtr.make_train_step(lambda b, l, x: jvit.vit_forward(b, l, x, spec), opt,
                               spec.num_classes)

    def train_client_fn(cid, overlay, data, rnd):
        lora, opt_state = overlay, opt.init(overlay)
        key = jax.random.key(rnd * 10 + cid)
        for _ in range(2):
            lora, opt_state, _ = step(base, lora, opt_state, data[0], data[1], key)
        return lora

    single = lambda p, x: jvit.vit_forward(p[0], p[1], x, spec)  # noqa: E731
    evaluator = jev.make_coalition_evaluator(lambda b, l, x: jvit.vit_forward(b, l, x, spec))

    def evaluate_fn(overlay):
        return jev.evaluate_model(single, (base, overlay), val_batches)

    def eval_factory(start_overlay, stacked):
        return lambda W: evaluator(base, jtm.materialize_coalitions(start_overlay, stacked, W),
                                   val_batches)

    cache = {}

    def run(estimator):
        if estimator not in cache:
            cache[estimator] = jrounds.run_federated_rounds(
                num_rounds=3, clients_data=setting["clients"], init_overlay=setting["lora0"],
                train_client_fn=train_client_fn, evaluate_fn=evaluate_fn,
                eval_coalitions_fn_factory=eval_factory, num_local_data=[16, 16, 16],
                participation=PARTICIPATION, estimator=estimator, shapley_budget=2)
        return cache[estimator]

    return run


@pytest.fixture(scope="module")
def port(setting):
    """The port's model, data and the three callables, in the JAX test's
    setting; ``run(estimator)`` runs ``run_federated_rounds`` once per
    estimator (budget 2) and returns (records, timer)."""
    spec = tvit.make_spec("micro")
    train_spec = spec.replace(**TRAIN_SPEC)
    base, lora0 = tree_from_numpy(setting["base"]), tree_from_numpy(setting["lora0"])
    clients = [(torch.tensor(X), torch.tensor(y)) for X, y in setting["clients"]]
    val_batches = [(torch.tensor(setting["val"][0]), torch.tensor(setting["val"][1]))]
    opt = ttr.sgd(5e-2)
    step = ttr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, train_spec),
                               spec.num_classes)

    def train_client_fn(cid, overlay, data, rnd):
        lora = ttr.trainable(overlay)
        state = opt.init(lora)
        for _ in range(2):
            lora, state, _ = step(base, lora, state, data[0], data[1])
        return lora

    single = lambda p, x: tvit.vit_forward(p[0], p[1], x, spec)  # noqa: E731
    evaluator = tev.make_coalition_evaluator(
        lambda b, lo, x: tvit.vit_forward_coalitions(b, lo, x, spec))

    def evaluate_fn(overlay):
        return tev.evaluate_model(single, (base, overlay), val_batches)

    def eval_factory(start_overlay, stacked):
        return lambda W: evaluator(base, ttm.materialize_coalitions(start_overlay, stacked, W),
                                   val_batches)

    cache = {}

    def run(estimator):
        if estimator not in cache:
            timer = StepTimer()
            records = trounds.run_federated_rounds(
                num_rounds=3, clients_data=clients, init_overlay=lora0,
                train_client_fn=train_client_fn, evaluate_fn=evaluate_fn,
                eval_coalitions_fn_factory=eval_factory, num_local_data=[16, 16, 16],
                participation=PARTICIPATION, estimator=estimator, shapley_budget=2,
                timer=timer)
            cache[estimator] = records, timer
        return cache[estimator]

    return dict(run=run, init_overlay=lora0, evaluate_fn=evaluate_fn, eval_factory=eval_factory)


def _hold(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.selection == w.selection
        np.testing.assert_allclose(g.utility, w.utility, atol=1e-5, rtol=0)
        assert (g.shapley is None) == (w.shapley is None)  # the same rounds chosen
        if w.shapley is None:
            continue
        assert len(g.shapley) == len(w.shapley) == 2
        for gd, wd in zip(g.shapley, w.shapley):
            assert sorted(gd) == sorted(wd) == [0, 1, 2]
            np.testing.assert_allclose([gd[c] for c in range(3)], [wd[c] for c in range(3)],
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("estimator", ESTIMATORS)
def test_run_federated_rounds_matches_jax(jax_runs, port, estimator):
    want = jax_runs(estimator)
    got, timer = port["run"](estimator)
    _hold(got, want)
    valued = [t for t, r in enumerate(got) if r.shapley is not None]
    assert 1 <= len(valued) <= 2  # the MILP budget
    spans = timer.summary()
    assert spans["train"]["count"] == 8 and spans["evaluate"]["count"] >= 3
    assert spans["milp"]["count"] == 1 and spans["shapley"]["count"] == len(valued)
    # no round keeps an autograd graph alive
    for rec in got:
        for d in rec.deltas:
            if d is not None:
                assert not any(t.requires_grad for t in ttm.tree_leaves(d))
        assert not any(t.requires_grad for t in ttm.tree_leaves(rec.global_overlay))


@pytest.mark.parametrize("estimator", ["exact", "comp_contrib"])
def test_the_sat_out_client_scores_zero(port, estimator):
    """Round 1, which the budget leaves unvalued, through ``round_game``:
    client 1 sat out, its delta is stacked as zeros, and its Shapley value
    is exactly 0.0 while the others' are not."""
    records, _ = port["run"]("exact")
    assert records[1].shapley is None and records[1].selection == [True, False, True]
    game = trounds.round_game(records, 1, port["init_overlay"], port["evaluate_fn"],
                              port["eval_factory"], [16, 16, 16])
    assert game.previous_utility == records[0].utility
    if estimator == "exact":
        sv = shapley_exact(game)
    else:
        sv = call_shapley_computation_method({}, game, rng=np.random.default_rng(1001))
    assert sv[0][1] == 0.0 and sv[1][1] == 0.0
    assert sv[1][0] != 0.0 and sv[1][2] != 0.0
    assert game.num_evaluations == 3  # {0}, {2}, {0, 2}


def test_gtg_evaluates_a_convergence_round_in_one_call(port):
    """GTG's prefix coalitions go to the evaluator in one call per
    convergence round, not one per coalition."""
    records, timer = port["run"]("gtg")
    valued = sum(r.shapley is not None for r in records)
    # per valued round: at most one call for the cached grand coalition and
    # one per convergence round of each utility dimension that needs any
    assert timer.summary()["coalition_eval"]["count"] <= 3 * valued


def test_unknown_estimator_is_refused_before_training():
    with pytest.raises(ValueError, match="unknown estimator"):
        trounds.run_federated_rounds(
            num_rounds=1, clients_data=[None], init_overlay={}, train_client_fn=None,
            evaluate_fn=None, eval_coalitions_fn_factory=None, num_local_data=[1],
            estimator="banzhaf")


def test_cli_refuses_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trounds.main(["--rounds", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    """``python -m shapley_vit_tpu_torch.driver.rounds --device cpu``: the
    micro ViT, three Dirichlet clients, two rounds, both valued."""
    out = str(tmp_path / "out")
    assert trounds.main(["--device", "cpu", "--rounds", "2", "--estimator", "comp_contrib",
                         "--out", out]) == 0
    with open(os.path.join(out, "shapley_rounds.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "round,utility,client_id,shapley_value"
    assert len(rows) == 1 + 2 * 2 * 3  # 2 rounds x 2 utilities x 3 clients
    values = [float(r.split(",")[3]) for r in rows[1:]]
    assert all(np.isfinite(values))
    assert "artifacts in" in capsys.readouterr().out


def test_chip_smoke_rounds_phase_holds_on_the_cpu(capsys):
    """``chip_smoke.py``'s ``rounds`` phase at the micro ViT on the CPU: the
    same driver run and checks as on the card (efficiency of exact, the
    sat-out client's 0.0, the cached Game's families with no new
    evaluation, the lazy utilities against the sequential reconstruction),
    but the launch check, which holds only where the kernels launch."""
    import importlib.util
    import json

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = Config()
    cfg.model.vit_variant, cfg.model.compute_dtype = "micro", "float32"
    cfg.data.synthetic_scale = 0.5  # 1000 training images: the three clients' 120/300/580
    smoke.phase_rounds((patch_embed, fused_attention_packed, fused_mlp_block, fused_attention),
                       cfg=cfg, device="cpu")
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith('{"phase": "rounds"')]
    out = json.loads(line[-1])
    assert out["ok"] and out["valued_rounds"] == [0, 2]
    assert out["round1_sat_out_sv"] == {"exact": [0.0, 0.0], "comp_contrib": [0.0, 0.0]}
    assert out["lazy"]["evaluator_calls"] == [[7, 9]]
    assert all(r["exact_efficiency_err"] <= 1e-6 for r in out["valued"])
