"""The port's service tools, as the JAX package's tests hold its own:
``driver/protocol`` (the JAX package's constants), ``driver/status`` (CLI,
JSON, exit codes, torn and NUL-corrupt CSV, an import without torch),
``driver/supervisor`` (recycle until clean, the crash policy, bounded
restarts, signal forwarding, and one supervised drain of the port's
service end to end), ``driver/report``, ``utils/metrics`` and
``fl/server.EvalServer``."""

import csv
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from shapley_vit_tpu.driver import protocol as jprotocol
from shapley_vit_tpu.fl.server import EvalServer as JEvalServer
from shapley_vit_tpu_torch.driver import protocol, report
from shapley_vit_tpu_torch.driver import status as st
from shapley_vit_tpu_torch.driver.supervisor import supervise
from shapley_vit_tpu_torch.fl.client import EvalClient
from shapley_vit_tpu_torch.fl.server import EvalServer
from shapley_vit_tpu_torch.models.convert import tree_from_numpy
from shapley_vit_tpu_torch.shapley import TabularGame, shapley_exact
from shapley_vit_tpu_torch.shapley.game import additive_table
from shapley_vit_tpu_torch.utils.metrics import AverageMeter, AverageMeterList
from shapley_vit_tpu_torch.utils.profiling import StepTimer
from test_torch_serve_common import port_model, service_cfg, write_epoch
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECYCLE = protocol.RECYCLE_EXIT_CODE


def test_protocol_matches_jax():
    for name in ("RECYCLE_EXIT_CODE", "STATE_FILENAME", "DRAIN_FILENAME"):
        assert getattr(protocol, name) == getattr(jprotocol, name)


# ---------------------------------------------------------------------------
# status
# ---------------------------------------------------------------------------

def _stage(tmp_path, rounds=4):
    out = tmp_path / "exp" / "svc"
    out.mkdir(parents=True)
    (out / protocol.STATE_FILENAME).write_text(json.dumps(dict(
        next_epoch=rounds, last_epoch=rounds - 1, rounds=2, total_rounds=rounds,
        generation=3, rss_mb=512.0, stop_reason="rss_ceiling",
    )))
    with open(out / "shapley_round.csv", "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["round", "utility", "client_id", "shapley_value"])
        for r in range(rounds):
            for dim in ("accuracy", "loss"):
                for c in range(3):
                    wr.writerow([r, dim, c, 0.01 * (r + 1) * (c + 1)])
    return str(out)


def test_status_reads_cursor_and_rounds(tmp_path):
    out = _stage(tmp_path)
    s = st.collect_status(out, last=2)
    assert s["state"]["generation"] == 3 and s["state"]["total_rounds"] == 4
    assert s["rounds_on_disk"] == 4
    assert sorted(s["recent_rounds"]) == ["2", "3"]  # the last two
    assert s["recent_rounds"]["3"]["accuracy"]["2"] == 0.01 * 4 * 3
    assert s["drain_requested"] is False
    assert s["state_age_s"] is not None and s["state_age_s"] < 60


def test_status_drain_flag_and_render(tmp_path):
    out = _stage(tmp_path)
    open(os.path.join(out, protocol.DRAIN_FILENAME), "w").close()
    s = st.collect_status(out)
    assert s["drain_requested"] is True
    buf = io.StringIO()
    st.render(s, out=buf)
    text = buf.getvalue()
    assert "generation=3" in text and "total_rounds=4" in text
    assert "DRAIN requested" in text and "round 3 [accuracy]" in text


def test_status_cli_json_and_exit_codes(tmp_path, capsys):
    out = _stage(tmp_path)
    assert st.main([out, "--json", "--last", "1"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["state"]["next_epoch"] == 4
    assert list(payload["recent_rounds"]) == ["3"]
    empty = str(tmp_path / "nothing")
    os.makedirs(empty)
    assert st.main([empty]) == 1  # nothing there: scripts can probe
    assert st.main(["--exp-dir", str(tmp_path / "exp"), "--exp-id", "svc"]) == 0


def test_status_tolerates_torn_csv_and_last_zero(tmp_path):
    out = _stage(tmp_path)
    with open(os.path.join(out, "shapley_round.csv"), "a") as f:
        f.write("3,accuracy,1\n")             # short row (torn mid-append)
        f.write("notanint,accuracy,1,0.5\n")  # garbage round id
    s = st.collect_status(out, last=2)
    assert s["rounds_on_disk"] == 4
    assert s["recent_rounds"]["3"]["accuracy"]["2"] == 0.01 * 4 * 3
    s = st.collect_status(out, last=0)
    assert s["recent_rounds"] == {} and s["rounds_on_disk"] == 4


def test_status_tolerates_nul_corrupt_csv(tmp_path):
    out = _stage(tmp_path)
    with open(os.path.join(out, "shapley_round.csv"), "ab") as f:
        f.write(b"\x00" * 64)
    assert st.collect_status(out, last=2)["rounds_on_disk"] >= 1


def test_status_reads_a_port_service_dir(tmp_path):
    """The status tool reads what the port's service writes."""
    cfg = service_cfg(tmp_path)
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)
    from shapley_vit_tpu_torch.driver import serve as tserve

    records = tserve.serve(cfg, max_rounds=1, timeout=10.0, policy="fail", device="cpu",
                           prewarm=False)
    s = json.loads(json.dumps(st.collect_status(cfg.output_dir)))  # as --json prints it
    assert s["state"]["next_epoch"] == 1 and s["rounds_on_disk"] == 1
    got = s["recent_rounds"]["0"]["loss"]
    assert {int(c): v for c, v in got.items()} == pytest.approx(records[0]["shapley"][1])


@pytest.mark.parametrize("module", ["status", "supervisor"])
def test_status_and_supervisor_import_without_torch(module):
    """Both tools stay usable on hosts without the compute stack."""
    code = (
        "import sys\n"
        "for name in ('torch', 'numpy', 'jax'):\n"
        "    sys.modules[name] = None\n"
        f"import shapley_vit_tpu_torch.driver.{module}\n"
        "assert 'shapley_vit_tpu_torch.driver.serve' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

def _scripted_child(tmp_path, codes):
    """A child that exits with codes[run_index] (the last code repeats),
    counting its runs in a file."""
    counter = tmp_path / "runs.txt"
    counter.write_text("0")
    script = tmp_path / "child.py"
    script.write_text(
        "import sys\n"
        f"p = {str(counter)!r}\n"
        "n = int(open(p).read())\n"
        "open(p, 'w').write(str(n + 1))\n"
        f"codes = {list(codes)!r}\n"
        "sys.exit(codes[min(n, len(codes) - 1)])\n"
    )
    return [sys.executable, str(script)], counter


def _runs(counter):
    return int(counter.read_text())


@pytest.mark.parametrize("codes,kw,rc,runs", [
    ([RECYCLE, RECYCLE, 0], {}, 0, 3),                        # recycle until clean
    ([7], {}, 7, 1),                                          # a crash stops
    ([7, 0], dict(restart_on_crash=True), 0, 2),              # ... unless opted in
    ([RECYCLE], dict(max_restarts=2), RECYCLE, 3),            # bounded restarts
], ids=["recycle_until_clean", "crash_stops", "crash_restarts_opt_in", "bounded"])
def test_supervise_restart_policy(tmp_path, codes, kw, rc, runs):
    cmd, counter = _scripted_child(tmp_path, codes)
    assert supervise(cmd, restart_delay_s=0.0, log_fn=lambda s: None, **kw) == rc
    assert _runs(counter) == runs


def test_supervise_exports_service_env(tmp_path):
    out = tmp_path / "env.txt"
    script = tmp_path / "child.py"
    script.write_text(
        "import os, sys\n"
        f"open({str(out)!r}, 'w').write(\n"
        "    os.environ.get('SVT_MAX_RSS_MB', '') + ':' + os.environ.get('SVT_START_EPOCH', ''))\n"
        "sys.exit(0)\n"
    )
    assert supervise([sys.executable, str(script)], max_rss_mb=123.5, restart_delay_s=0.0,
                     log_fn=lambda s: None) == 0
    assert out.read_text() == "123.5:auto"


def test_supervise_forwards_stop_signal(tmp_path):
    """SIGTERM to the supervisor reaches the child and ends the chain."""
    ready, got = tmp_path / "ready.txt", tmp_path / "got.txt"
    counter = tmp_path / "runs.txt"
    counter.write_text("0")
    script = tmp_path / "child.py"
    script.write_text(
        "import signal, sys, time\n"
        f"open({str(counter)!r}, 'w').write(str(int(open({str(counter)!r}).read() or 0) + 1))\n"
        "def bye(s, f):\n"
        f"    open({str(got)!r}, 'w').write(str(s))\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, bye)\n"
        f"open({str(ready)!r}, 'w').close()\n"
        "time.sleep(30)\n"
        "sys.exit(7)\n"
    )

    def fire():
        deadline = time.time() + 20
        while time.time() < deadline and not ready.exists():
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=fire)
    t.start()
    logs = []
    rc = supervise([sys.executable, str(script)], restart_on_crash=True, restart_delay_s=0.0,
                   log_fn=logs.append)
    t.join()
    assert rc == 0, logs
    assert got.read_text() == str(int(signal.SIGTERM))
    assert _runs(counter) == 1  # no restart after a stop


def test_stop_during_restart_delay_spawns_no_doomed_child(tmp_path):
    cmd, counter = _scripted_child(tmp_path, [RECYCLE])

    def fire():
        deadline = time.time() + 20
        while time.time() < deadline and _runs(counter) < 1:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=fire)
    t.start()
    logs = []
    rc = supervise(cmd, restart_delay_s=3.0, log_fn=logs.append)
    t.join()
    assert rc == 0, logs
    assert _runs(counter) == 1, logs


def test_supervisor_runs_the_port_service():
    from shapley_vit_tpu_torch.driver import supervisor

    seen = {}

    def fake(child, **kw):
        seen["child"] = child
        return 0

    orig = supervisor.supervise
    supervisor.supervise = fake
    try:
        assert supervisor.main(["--max-rss-mb", "10", "--model-type", "ViT-micro"]) == 0
    finally:
        supervisor.supervise = orig
    assert seen["child"][1:] == ["-m", "shapley_vit_tpu_torch.driver.serve",
                                 "--model-type", "ViT-micro"]


def test_supervised_port_service_drains_end_to_end(tmp_path):
    """The supervised service (the port's ``serve.main`` in a child process,
    on the CPU) idles waiting for epoch 1 when SIGTERM reaches the
    supervisor: the forwarded signal drains the child — cursor persisted,
    exit 0, no restart.

    The signal goes out only once the cursor shows the service idle (its
    drain handlers are installed by then), however long a loaded machine
    takes to import torch and run round 0 in the child. If the service
    never gets there within the deadline, the supervisor is still stopped
    (else the test would hang) and the test fails saying so. A SIGTERM can
    never reach this process after ``supervise`` has put its own handler
    back: the test's handler sits under it."""
    cfg = service_cfg(tmp_path)
    spec, _, init = port_model(cfg)
    write_epoch(cfg, spec, init, 0)  # epoch 1 never arrives
    child = tmp_path / "serve_child.py"
    child.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from shapley_vit_tpu_torch.driver.serve import main\n"
        "sys.exit(main(sys.argv[1:], device='cpu'))\n"
    )
    # one intra-op thread in the child too (torch_one_thread.py says why)
    env = dict(os.environ, LOCAL_MODEL_PATH=cfg.paths.local_model_path,
               GLOBAL_MODEL_PATH=cfg.paths.global_model_path,
               VALIDATION_DATASET=str(tmp_path / "none"), OMP_NUM_THREADS="1")
    env.pop("SVT_START_EPOCH", None)
    out_dir = str(tmp_path / "exp" / "svc")

    idle_after_s = []    # seconds from the start to the idle cursor
    supervised = threading.Event()  # supervise() has returned

    def fire_when_idle():
        t0 = time.time()
        while time.time() < t0 + 600 and not supervised.is_set():
            s = protocol.read_service_state(out_dir)
            if s and s.get("next_epoch") == 1:
                idle_after_s.append(time.time() - t0)
                break
            time.sleep(0.1)
        if not supervised.is_set():
            os.kill(os.getpid(), signal.SIGTERM)

    late = []
    previous = signal.signal(signal.SIGTERM, lambda signum, frame: late.append(signum))
    t = threading.Thread(target=fire_when_idle)
    t.start()
    logs = []
    try:
        rc = supervise([sys.executable, str(child), "--model-type", "ViT-micro",
                        "--exp-dir", str(tmp_path / "exp"), "--exp-id", "svc"],
                       env=env, restart_delay_s=0.0, log_fn=logs.append)
    finally:
        supervised.set()
        t.join()
        signal.signal(signal.SIGTERM, previous)
    assert idle_after_s, ("the service never idled waiting for epoch 1 "
                          f"(stopped at the deadline or exited first): {logs}")
    assert rc == 0, logs
    state = protocol.read_service_state(out_dir)
    assert state["next_epoch"] == 1 and state["stop_reason"] == "drain"
    assert os.path.exists(os.path.join(cfg.paths.global_model_path, "ViT_global_epoch_0.npz"))
    assert any("stop signal" in ln for ln in logs), logs


# ---------------------------------------------------------------------------
# report, metrics, server
# ---------------------------------------------------------------------------

def test_render_round_report(tmp_path):
    values = np.array([[1.0, -0.2], [2.0, 0.1], [0.5, 0.3]])
    game = TabularGame(additive_table(values), n_all=3)
    timer = StepTimer()
    with timer.span("shapley"):
        sv = shapley_exact(game)
    paths = report.render_round_report(str(tmp_path), sv, game=game, round_idx=0, timer=timer)
    for p in paths:
        assert os.path.getsize(p) > 0
    with open(os.path.join(tmp_path, "shapley_round.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 6
    accs = {int(r["client_id"]): float(r["shapley_value"]) for r in rows
            if r["utility"] == "accuracy"}
    np.testing.assert_allclose([accs[i] for i in range(3)], values[:, 0], atol=1e-9)
    with open(os.path.join(tmp_path, "utility_table_r0.csv")) as f:
        assert len(list(csv.DictReader(f))) == 7
    sv2 = [{k: v * 0.5 for k, v in d.items()} for d in sv]
    report.write_shapley_csv(os.path.join(tmp_path, "shapley_round.csv"), sv2, round_idx=1)
    with open(os.path.join(tmp_path, "shapley_round.csv")) as f:
        assert len(list(csv.DictReader(f))) == 12
    report.plot_shapley_rounds([sv, sv2], str(tmp_path / "traj.png"))
    assert os.path.getsize(tmp_path / "traj.png") > 0


def test_report_plots_and_async_worker(tmp_path):
    sv = [{0: 0.2, 1: -0.1}, {0: 1.0, 1: 0.4}]
    se = [{0: 0.05, 1: 0.02}, {0: 0.1, 1: 0.3}]
    paths = report.render_round_report(str(tmp_path), sv, se=se, round_idx=3,
                                       plots_async=True)
    assert report.flush_async_plots() == 0
    assert any(p.endswith("sv_bar_r3.png") and os.path.getsize(p) > 0 for p in paths)
    paths = report.render_round_report(str(tmp_path), sv, round_idx=5, render_plots=False)
    assert not any(p.endswith(".png") for p in paths)

    def boom():
        raise OSError("disk gone")

    report.submit_async_artifact(boom)
    assert report.flush_async_plots(raise_errors=False) == 1
    assert report.pending_artifact_jobs() == 0
    # the saliency PNG renders on the same worker, after the plots queued
    # before it (pyplot is not re-entrant), and is waited for
    spec, base, lora = port_model(service_cfg(tmp_path))
    paths = report.render_round_report(str(tmp_path), sv, round_idx=6, plots_async=True)
    images = np.random.default_rng(0).uniform(size=(2, spec.image, spec.image, 3))
    sal = report.render_saliency(str(tmp_path / "sal"), base, lora, images, spec, round_idx=6)
    assert report.pending_artifact_jobs() == 0
    assert os.path.getsize(sal) > 0 and any(p.endswith("sv_bar_r6.png") and os.path.getsize(p) > 0
                                             for p in paths)


def test_average_meters():
    m = AverageMeter()
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0 and m.count == 2 and m.sum == 4.0
    m.update(5.0, n=2)
    assert m.count == 4 and m.avg == pytest.approx(3.5)
    ml = AverageMeterList(2)
    ml.update([1.0, 2.0])
    ml.update([3.0, 4.0])
    assert ml.avg == [2.0, 3.0] and ml.value == [3.0, 4.0] and ml.sum == [4.0, 6.0]
    ml.reset()
    assert ml.avg == [0.0, 0.0]


def test_eval_server_aggregation_matches_jax():
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    deltas = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
              for _ in range(3)]
    sizes = (10, 30, 60)
    jclients = [type("C", (), {"num_local_data_train": n})() for n in sizes]
    tclients = [EvalClient(i, num_local_data_train=n) for i, n in enumerate(sizes)]
    js, ts = JEvalServer(init, jclients), EvalServer(tree_from_numpy(init), tclients)
    np.testing.assert_allclose(ts.get_agg_ratio(), js.get_agg_ratio())
    want = jax.device_get(js.model_agg_delta(init, deltas))
    got = ts.model_agg_delta(tree_from_numpy(init), [tree_from_numpy(d) for d in deltas])
    for k in init:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, rtol=0)
    got = ts.model_agg([tree_from_numpy(d) for d in deltas])
    want = jax.device_get(js.model_agg(deltas))
    for k in init:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, rtol=0)
    assert len(ts.clients_sel(0.5, rng=np.random.default_rng(1))) == 2
    assert isinstance(got["a"], torch.Tensor)
