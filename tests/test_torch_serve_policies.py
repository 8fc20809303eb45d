"""The port's service policies, as the JAX package's ``tests/test_serve.py``
holds its own: drain by request and by the DRAIN file (stale and fresh),
timeout, all-corrupt rounds and their consecutive bound, a hostile pickle,
utility-table pruning and a mid-round resume from the table. Micro ViT on
the CPU."""

import glob
import os
import threading
import time
from itertools import combinations

import pytest

from shapley_vit_tpu_torch.driver import serve as tserve
from shapley_vit_tpu_torch.fl import checkpoint as ckpt
from shapley_vit_tpu_torch.utils import tb_events
from test_torch_serve_common import corrupt_epoch, port_model, service_cfg, write_epoch


@pytest.fixture
def cfg(tmp_path):
    return service_cfg(tmp_path)


def serve(cfg, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("prewarm", False)
    return tserve.serve(cfg, **kw)


def _drain_when_round0_done(cfg, action):
    """Fire ``action`` once round 0 has persisted its cursor, whether the
    service is still reporting round 0 or already waiting for epoch 1."""
    def poke():
        deadline = time.time() + 60
        while time.time() < deadline:
            st = tserve.read_service_state(cfg.output_dir)
            if st and st.get("next_epoch") == 1:
                action()
                return
            time.sleep(0.05)

    t = threading.Thread(target=poke)
    t.start()
    return t


def test_serve_stops_on_timeout(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)  # epoch 1 never arrives
    records = serve(cfg, max_rounds=5, timeout=0.5, policy="fail")
    assert len(records) == 1 and records.stop_reason == "timeout"
    assert tserve.read_service_state(cfg.output_dir)["stop_reason"] == "timeout"


def test_serve_skip_policy_stops_when_nothing_arrives(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    records = serve(cfg, max_rounds=5, timeout=0.3, policy="skip")
    assert len(records) == 1 and records.stop_reason == "no_checkpoints"


def test_serve_drains_on_request(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)  # epoch 1 never arrives
    t = _drain_when_round0_done(cfg, tserve.request_drain)
    t0 = time.time()
    records = serve(cfg, max_rounds=5, timeout=120.0, policy="fail")
    t.join()
    assert len(records) == 1 and records[0]["epoch"] == 0
    assert records.stop_reason == "drain"
    assert time.time() - t0 < 90  # escaped the idle wait early
    state = tserve.read_service_state(cfg.output_dir)
    assert state["next_epoch"] == 1 and state["stop_reason"] == "drain"


def test_serve_drain_file_stale_vs_fresh(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    drain_path = os.path.join(cfg.ensure_output_dir(), tserve.DRAIN_FILENAME)
    open(drain_path, "w").close()  # stale: must NOT stop the fresh service
    t = _drain_when_round0_done(cfg, lambda: open(drain_path, "w").close())
    records = serve(cfg, max_rounds=5, timeout=120.0, policy="fail")
    t.join()
    assert len(records) == 1 and records.stop_reason == "drain"
    assert tserve.read_service_state(cfg.output_dir)["next_epoch"] == 1
    assert os.path.exists(drain_path)  # the request outlives the service


def test_serve_survives_all_corrupt_round(cfg):
    spec, _, init = port_model(cfg)
    corrupt_epoch(cfg, 0)
    write_epoch(cfg, spec, init, 1)
    records = serve(cfg, max_rounds=1, timeout=30.0, policy="fail")
    assert [r["epoch"] for r in records] == [1]


def test_serve_bounds_consecutive_corrupt_rounds(cfg):
    for epoch in range(4):
        corrupt_epoch(cfg, epoch, payload=b"garbage")
    records = serve(cfg, max_rounds=1, timeout=1.0, policy="fail", max_skipped_rounds=2)
    assert records == [] and records.stop_reason == "corrupt_epochs"
    # the two skipped epochs were consumed; the third stopped the service
    assert tserve.read_service_state(cfg.output_dir)["next_epoch"] == 2


def test_unbounded_serve_outlives_corrupt_streak(cfg):
    spec, _, init = port_model(cfg)
    corrupt_epoch(cfg, 0, payload=b"garbage")
    write_epoch(cfg, spec, init, 1)
    records = serve(cfg, max_rounds=None, timeout=1.0, policy="fail", max_skipped_rounds=0)
    assert [r["epoch"] for r in records] == [1] and records.stop_reason == "timeout"


def test_serve_survives_hostile_pickle_client(cfg):
    """A checkpoint whose pickle carries an execution payload is refused at
    parse time (``torch.load(weights_only=True)``) and its client valued as
    an absentee; the payload never runs."""
    import zipfile

    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    marker = os.path.join(cfg.paths.local_model_path, "pwned")
    cmd = f"touch {marker}"
    payload = (b"\x80\x02cos\nsystem\n" + b"X" + len(cmd.encode()).to_bytes(4, "little")
               + cmd.encode() + b"\x85R.")
    evil = os.path.join(cfg.paths.local_model_path, "client_2_model", "ViT_epoch_0.pth.tar")
    with zipfile.ZipFile(evil, "w") as zf:  # overwrite client 2's upload
        zf.writestr("evil/data.pkl", payload)
        zf.writestr("evil/version", b"3\n")
    records = serve(cfg, max_rounds=1, timeout=30.0, policy="fail")
    assert len(records) == 1 and len(records[0]["shapley"]) == 2
    assert not os.path.exists(marker), "hostile pickle was executed"
    assert records[0]["selection"] == [True, False, True]
    assert set(records[0]["shapley"][0]) == {0, 1, 2}


def test_serve_prunes_old_utility_tables(cfg):
    spec, _, init = port_model(cfg)
    for e in range(3):
        write_epoch(cfg, spec, init, e)
    cfg.shapley.keep_utility_tables = 1
    records = serve(cfg, max_rounds=3, timeout=10.0, policy="fail")
    assert len(records) == 3
    out = cfg.output_dir
    assert os.path.exists(os.path.join(out, "utility_table_epoch_2.npz"))
    for e in (0, 1):
        assert not os.path.exists(os.path.join(out, f"utility_table_epoch_{e}.npz")), e
    # the startup sweep clears a backlog the per-round path cannot reach
    for e in (0, 1):
        open(os.path.join(out, f"utility_table_epoch_{e}.npz"), "wb").close()
    records = serve(cfg, max_rounds=1, timeout=0.5, policy="fail", start_epoch=3)
    assert records.stop_reason == "timeout"
    for e in (0, 1):
        assert not os.path.exists(os.path.join(out, f"utility_table_epoch_{e}.npz")), e
    assert os.path.exists(os.path.join(out, "utility_table_epoch_2.npz"))


def test_serve_prunes_across_skipped_epochs(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    corrupt_epoch(cfg, 1)
    write_epoch(cfg, spec, init, 2)
    cfg.shapley.keep_utility_tables = 1
    records = serve(cfg, max_rounds=2, timeout=10.0, policy="fail")
    assert [r["epoch"] for r in records] == [0, 2]
    out = cfg.output_dir
    assert os.path.exists(os.path.join(out, "utility_table_epoch_2.npz"))
    assert not os.path.exists(os.path.join(out, "utility_table_epoch_0.npz"))


def test_serve_resumes_mid_round_from_utility_table(cfg):
    """With a complete table staged for the epoch, the round makes no fresh
    coalition evaluation and its SVs reflect the staged utilities."""
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    table = {frozenset(c): [0.01 * len(c), -0.01 * len(c)]
             for r in range(1, 4) for c in combinations(range(3), r)}
    ckpt.save_utility_table(os.path.join(cfg.ensure_output_dir(), "utility_table_epoch_0.npz"),
                            table)
    records = serve(cfg, max_rounds=1, timeout=10.0, policy="fail")
    assert len(records) == 1 and records[0]["evals"] == 0
    sv_acc = records[0]["shapley"][0]
    assert len(set(round(v, 9) for v in sv_acc.values())) == 1


def test_serve_records_include_se_and_artifacts(cfg):
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    write_epoch(cfg, spec, init, 1)
    cfg.obs.render_plots = True  # matplotlib PNGs on the artifact worker
    records = serve(cfg, max_rounds=2, timeout=30.0, policy="fail")
    se = records[0]["shapley_se"]
    assert len(se) == 2 and all(v >= 0 for d in se for v in d.values())
    out = cfg.output_dir
    for name in ("shapley_round.csv", "sv_bar_r1.png", "sv_rounds.png", "timing_r1.csv",
                 "utility_table_r1.csv"):
        assert os.path.exists(os.path.join(out, name)), name
    assert set(records[0]["phases"]) >= {"ingest", "stack_deltas", "shapley_round"}


def test_serve_prewarm_keeps_results_identical(cfg, tmp_path):
    import shutil

    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    warm = serve(cfg, max_rounds=1, timeout=30.0, policy="fail", prewarm=True)
    shutil.rmtree(cfg.obs.exp_dir)
    cold = serve(cfg, max_rounds=1, timeout=30.0, policy="fail", prewarm=False)
    assert warm.prewarm_s > 0 and cold.prewarm_s is None
    assert warm[0]["shapley"] == cold[0]["shapley"]


def test_serve_writes_grad_cam_overlays(cfg, tmp_path):
    # per-round Grad-CAM overlays of the global model, listed among the
    # round's artifacts, with their TensorBoard images (JAX
    # tests/test_serve.py:640-653)
    cfg.obs.use_grad_cam = cfg.obs.use_tensorboard = True
    cfg.obs.sal_image_dir = str(tmp_path / "sal")
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    records = serve(cfg, max_rounds=1, timeout=30.0, policy="fail")
    p = os.path.join(cfg.obs.sal_image_dir, cfg.obs.exp_id, "saliency_r0.png")
    assert os.path.getsize(p) > 0 and p in records[0]["artifacts"]
    (events,) = glob.glob(os.path.join(cfg.output_dir, "tensorboard", "events.out.tfevents.*"))
    images = tb_events.read_image_events(events)
    assert [(tag, step) for tag, *_, step in images] == [
        (f"saliency/grad_cam/img_{i}", 0) for i in range(4)]


def test_serve_refuses_what_is_not_ported(cfg, monkeypatch):
    monkeypatch.setattr(tserve, "_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="one process"):
        serve(cfg, max_rounds=1)
