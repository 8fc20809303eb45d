"""The port's continuous service against the JAX package's ``serve()``.

Both services run two rounds on the same epoch drops (written once, read by
both), the same validation set and the same weights (the JAX package's,
carried over as numpy into the port's ``build_model``), at float32 with the
merged evaluator. Per-round Shapley values and the chained
``previous_utility`` agree within 1e-4; each epoch's exported global overlay
agrees leaf by leaf; the port's TensorBoard scalars read back. A recycle at
``max_rss_mb`` followed by ``start_epoch="auto"`` reproduces the
uninterrupted run.
"""

import os

import jax
import numpy as np
import pytest

from shapley_vit_tpu.config import Config as JConfig
from shapley_vit_tpu.driver import serve as jserve
from shapley_vit_tpu.driver import start as jstart
from shapley_vit_tpu.fl import ingestion as jing
from shapley_vit_tpu_torch.driver import serve as tserve
from shapley_vit_tpu_torch.driver import start as tstart
from shapley_vit_tpu_torch.fl import checkpoint as ckpt
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from test_torch_serve_common import service_cfg, write_epoch
from torch_one_thread import one_torch_thread  # noqa: F401


def _port_weights(monkeypatch, base, lora):
    """The port's services build the JAX package's weights."""
    real = tstart.build_model

    def build_model(cfg, generator=None, device="cuda"):
        spec = real(cfg, device="cpu")[0]
        return spec, tree_from_numpy(base, device), tree_from_numpy(lora, device)

    monkeypatch.setattr(tstart, "build_model", build_model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    jcfg = service_cfg(tmp / "jax", JConfig, local=tmp / "local")
    jcfg.model.compute_dtype = "float32"
    jcfg.dist.mesh = "off"
    spec_j, base, lora = jstart.build_model(jcfg)
    base, lora = jax.device_get(base), jax.device_get(lora)
    for e in (0, 1):
        write_epoch(jcfg, spec_j, lora, e, save=jing.save_lora_checkpoint)
    rec_j = jserve.serve(jcfg, max_rounds=2, timeout=30.0, policy="fail")

    tcfg = service_cfg(tmp / "torch", local=tmp / "local")
    tcfg.model.compute_dtype = "float32"
    tcfg.obs.use_tensorboard = True
    with pytest.MonkeyPatch.context() as mp:
        _port_weights(mp, base, lora)
        rec_t = tserve.serve(tcfg, max_rounds=2, timeout=30.0, policy="fail", device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, rec_j=rec_j, rec_t=rec_t, base=base, lora=lora, tmp=tmp)


def _svs(records):
    return np.array([[[r["shapley"][d][c] for c in range(3)] for d in (0, 1)] for r in records])


def test_two_rounds_match_jax_serve(runs):
    rec_j, rec_t = runs["rec_j"], runs["rec_t"]
    assert len(rec_t) == 2 and rec_t.stop_reason == "max_rounds"
    assert [r["epoch"] for r in rec_t] == [0, 1]
    assert np.abs(_svs(rec_j)).max() > 1e-3
    np.testing.assert_allclose(_svs(rec_t), _svs(rec_j), atol=1e-4, rtol=0)
    # the chained previous_utility: each round's new global utility
    np.testing.assert_allclose([r["utility"] for r in rec_t], [r["utility"] for r in rec_j],
                               atol=1e-4, rtol=0)
    assert rec_t[0]["utility"] != rec_t[1]["utility"]
    # round 1's drops were on disk during round 0: the prefetch fired
    assert [r["pipelined_ingest"] for r in rec_t] == [False, True]
    assert rec_t.prewarm_s is not None and rec_t.prewarm_s > 0
    state = tserve.read_service_state(runs["tcfg"].output_dir)
    assert state["next_epoch"] == 2 and state["stop_reason"] == "max_rounds"
    np.testing.assert_allclose(state["previous_utility"], rec_t[1]["utility"], rtol=0, atol=0)


def test_global_export_matches_jax_leaf_by_leaf(runs):
    for e in (0, 1):
        name = f"ViT_global_epoch_{e}.npz"
        with np.load(os.path.join(runs["jcfg"].paths.global_model_path, name)) as zj, \
                np.load(os.path.join(runs["tcfg"].paths.global_model_path, name)) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                np.testing.assert_allclose(zt[k], zj[k], atol=1e-6, rtol=0, err_msg=k)


def test_tensorboard_round_scalars(runs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tb_dir = os.path.join(runs["tcfg"].output_dir, "tensorboard")
    assert any("tfevents" in f for f in os.listdir(tb_dir))
    acc = EventAccumulator(tb_dir)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"global/accuracy", "global/loss", "round/wall_s", "health/rss_mb",
            "health/artifact_backlog", "health/generation"} <= tags
    assert any(t.startswith("round/phase_s/") for t in tags)
    got = [e.value for e in acc.Scalars("shapley/loss/client_2")]
    want = [r["shapley"][1][2] for r in runs["rec_t"]]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert [e.step for e in acc.Scalars("global/loss")] == [0, 1]
    assert acc.Scalars("health/rss_mb")[0].value > 0


def test_recycle_then_auto_resume_reproduces_the_uninterrupted_run(runs, monkeypatch):
    """A 1 MB ceiling stops the service after its first round (any process
    is above it) with the cursor, the chained utility and the global overlay
    on disk; ``start_epoch="auto"`` resumes at epoch 1 and scores it as the
    uninterrupted service did."""
    _port_weights(monkeypatch, runs["base"], runs["lora"])
    cfg = service_cfg(runs["tmp"] / "recycle", local=runs["tmp"] / "local")
    cfg.model.compute_dtype = "float32"
    r1 = tserve.serve(cfg, max_rounds=5, timeout=5.0, policy="fail", max_rss_mb=1.0,
                      device="cpu")
    assert [r["epoch"] for r in r1] == [0] and r1.stop_reason == "rss_ceiling"
    state = tserve.read_service_state(cfg.output_dir)
    assert state["next_epoch"] == 1 and state["stop_reason"] == "rss_ceiling"
    assert state["rss_mb"] > 1.0 and state["generation"] == 1 and state["total_rounds"] == 1
    assert os.path.exists(os.path.join(cfg.output_dir, tserve.OVERLAY_FILENAME))

    r2 = tserve.serve(cfg, max_rounds=1, timeout=5.0, policy="fail", start_epoch="auto",
                      device="cpu")
    assert [r["epoch"] for r in r2] == [1] and r2.stop_reason == "max_rounds"
    state = tserve.read_service_state(cfg.output_dir)
    assert state["next_epoch"] == 2 and state["generation"] == 2
    assert state["total_rounds"] == 2 and state["rounds"] == 1
    np.testing.assert_allclose(_svs(list(r1) + list(r2)), _svs(runs["rec_t"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(r2[0]["utility"], runs["rec_t"][1]["utility"], atol=1e-5, rtol=0)


def test_a_stale_overlay_file_restarts_the_chain(runs, monkeypatch):
    """An overlay file that does not match the cursor's digest is not used:
    the resumed service starts from the initial overlay and its utility."""
    _port_weights(monkeypatch, runs["base"], runs["lora"])
    cfg = service_cfg(runs["tmp"] / "stale", local=runs["tmp"] / "local")
    cfg.model.compute_dtype = "float32"
    tserve.serve(cfg, max_rounds=1, timeout=5.0, policy="fail", device="cpu", prewarm=False)
    ckpt.save_pytree(os.path.join(cfg.output_dir, tserve.OVERLAY_FILENAME),
                     tree_from_numpy(runs["lora"]))
    r = tserve.serve(cfg, max_rounds=1, timeout=5.0, policy="fail", start_epoch="auto",
                     device="cpu", prewarm=False)
    assert [x["epoch"] for x in r] == [1]
    # round 1 was scored against the initial utility, not round 0's
    assert np.abs(_svs(r) - _svs(runs["rec_t"][1:])).max() > 1e-6
