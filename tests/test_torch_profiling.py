"""The port's program spans and counters (``utils/profiling.py``).

On the CPU: with no profiler a span records nothing and opens no
``RecordFunction``; under ``torch.profiler`` spans nest with the right
parents and appear as ``cpu_op`` events named ``svt.<name>`` (never a
``user_annotation``); self time, ``take()``, the buffer's bound and its
dropped count, ``trace()`` clearing the buffer, ``StepTimer.span``; a
micro round through ``build_eval_backend`` and
``run_configured_comp_contrib`` records the tree of the round's spans; and
``eval.place_bytes`` on CPU grids equals the bytes from the shapes.

The test marked ``cuda`` checks on the card that a span timed on a CUDA
device adds no device-side event and reads its device time:

    python -m pytest --noconftest -q tests/test_torch_profiling.py -m cuda
"""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shapley_vit_tpu_torch.utils import profiling
from shapley_vit_tpu_torch.utils.profiling import StepTimer, count, span, take, trace
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def empty_buffer():
    take()
    yield
    take()


class FakeClock:
    """``time.perf_counter_ns`` that advances by the given steps."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        return self.now

    def perf_counter(self):
        return self.now / 1e9


def _work():
    return (torch.ones(8, 8) @ torch.ones(8, 8)).sum()


def test_no_profiler_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"RecordFunction opened for {name}")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not profiling.recording()
    timer = StepTimer()
    with span("outer"), span("inner", device="cpu"), timer.span("phase"):
        _work()
    count("bytes", 10)
    got = take()
    assert got.spans == [] and got.counters == {} and got.dropped == 0
    assert len(timer.times("phase")) == 1  # the timer's own durations stay


def _names(events):
    return {e.name: e for e in events if e.name.startswith(profiling.SPAN_PREFIX)}


def test_spans_nest_under_the_profiler_as_cpu_ops(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("round"):
            with span("eval"):
                with span("eval.place"):
                    _work()
                with span("eval.readback"):
                    _work()
            with span("score"):
                _work()
            count("eval.place_bytes", 64)
            count("eval.place_bytes", 36)
    got = take()
    assert [(s.name, s.parent) for s in got.spans] == [
        ("eval.place", "eval"), ("eval.readback", "eval"), ("eval", "round"),
        ("score", "round"), ("round", None)]
    assert got.counters == {"eval.place_bytes": 100.0}
    assert {s.thread for s in got.spans} == {threading.get_ident()}
    events = _names(prof.events())
    assert set(events) == {"svt.round", "svt.eval", "svt.eval.place", "svt.eval.readback",
                           "svt.score"}
    assert events["svt.eval.place"].cpu_parent.name == "svt.eval"
    assert events["svt.eval"].cpu_parent.name == "svt.round"
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith(profiling.SPAN_PREFIX)}
    assert set(cats) == set(events)
    assert set(cats.values()) == {"cpu_op"}


def test_self_time_and_take(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling, "time", clock)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("estimator"):            # 0 .. 100
            clock.now = 10
            with span("game.evaluate"):    # 10 .. 30
                clock.now = 30
            clock.now = 40
            with span("game.evaluate"):    # 40 .. 70, with a child 50 .. 60
                clock.now = 50
                with span("eval"):
                    clock.now = 60
                clock.now = 70
            clock.now = 100
    got = take()
    assert got.total_s("estimator") == pytest.approx(100e-9)
    assert got.self_s("estimator") == pytest.approx(50e-9)
    assert got.total_s("game.evaluate") == pytest.approx(50e-9)
    assert got.self_s("game.evaluate") == pytest.approx(40e-9)
    assert got.self_s("eval") == pytest.approx(10e-9)
    assert got.device_s("eval") is None
    assert got.total_s("absent") == 0.0 and got.of("absent") == []
    again = take()  # take() drains
    assert again.spans == [] and again.counters == {}


def test_buffer_bound_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling._BUFFER, "limit", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with span(f"s{i}"):
                pass
    got = take()
    assert [s.name for s in got.spans] == ["s0", "s1", "s2"]
    assert got.dropped == 2
    assert take().dropped == 0


def test_buffer_under_many_threads():
    """Counts and records stay whole with more writers than cores and a
    short switch interval."""
    buf = profiling._Buffer(limit=5000)
    threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write():
            for _ in range(per):
                buf.count("n", 1.0)
                buf.add(("x", None, 0, 0, 1, 0, None))

        ts = [threading.Thread(target=write) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    records, counters, dropped = buf.drain()
    assert counters == {"n": float(threads * per)}
    assert len(records) == 5000 and dropped == threads * per - 5000


def test_trace_clears_the_buffer_on_entry(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("before"):
            pass
        count("before", 1)
    with trace(str(tmp_path)):
        with span("inside"):
            _work()
    got = take()
    assert [s.name for s in got.spans] == ["inside"] and got.counters == {}
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "svt.inside" in names and "svt.before" not in names


@pytest.mark.parametrize("profiled", [False, True])
def test_step_timer_span_emits_a_program_span(profiled):
    timer = StepTimer()
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        for _ in range(2):
            with timer.span("shapley_round"):
                with span("estimator"):
                    _work()
    assert len(timer.times("shapley_round")) == 2
    s = timer.summary()["shapley_round"]
    assert s["count"] == 2 and s["total_s"] > 0 and s["max_s"] <= s["total_s"]
    got = take()
    want = [("estimator", "shapley_round"), ("shapley_round", None)] * 2 if profiled else []
    assert [(r.name, r.parent) for r in got.spans] == want


# ---------------------------------------------------------------------------
# the round's spans on the CPU
# ---------------------------------------------------------------------------

def _micro(devices, coalition_shards=0):
    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.data.arrays import ArrayDataset
    from shapley_vit_tpu_torch.driver import start as tstart
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy
    from shapley_vit_tpu_torch.ops.tree_math import tree_map

    cfg = Config()
    cfg.model.vit_variant = "micro"
    cfg.model.compute_dtype = "float32"
    cfg.shapley.num_clients = 3
    cfg.shapley.samples_per_client = 2
    cfg.shapley.persist_utility_table = False
    cfg.data.eval_batch_size = 8
    cfg.dist.mesh_coalition_shards = coalition_shards
    spec, base, lora = tstart.build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    deltas = [tree_map(lambda a: 0.1 * rng.normal(size=a.shape).astype(np.float32),
                       tree_to_numpy(lora)) for _ in range(3)]
    backend, eval_coalitions, _ = tstart.build_eval_backend(cfg, spec, base, lora, device="cpu",
                                                            devices=devices)
    images = rng.normal(size=(12, spec.image, spec.image, 3)).astype(np.float32)
    labels = rng.integers(0, spec.num_classes, size=12)
    data = backend.device_batches(ArrayDataset(images=images, labels=labels), 8)
    backend.evaluate_single(base, lora, data, dataset_size=12)  # as the drivers' set-up does
    return cfg, base, lora, deltas, backend, eval_coalitions, data


@pytest.mark.parametrize("devices,shards", [(["cpu"], 0), (["cpu"] * 4, 1)],
                         ids=["one-device", "1x4-grid"])
def test_round_records_the_tree_of_its_spans(devices, shards):
    from shapley_vit_tpu_torch.models.convert import tree_from_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm
    from shapley_vit_tpu_torch.shapley import Game, run_configured_comp_contrib

    cfg, base, lora, deltas, backend, eval_coalitions, data = _micro(devices, shards)
    with profile(activities=[ProfilerActivity.CPU]):
        stacked = tree_from_numpy(tm.tree_stack_host(deltas))
        game = Game(eval_coalitions_fn=lambda W: eval_coalitions(lora, stacked, W, data,
                                                                 dataset_size=12),
                    num_local_data=[1.0, 2.0, 3.0], client_selection_vector=[True] * 3,
                    previous_utility=[0.5, 1.0], utility_dim=2, n_all=3)
        run_configured_comp_contrib(game, cfg.shapley, rng=np.random.default_rng(0))
    got = take()
    assert {(s.name, s.parent) for s in got.spans} == {
        ("tree.stack_host", None), ("tree.to_device", None),
        ("estimator", None), ("game.evaluate", "estimator"),
        ("eval.fold", "game.evaluate"), ("eval", "game.evaluate"),
        ("eval.place", "eval"), ("eval.enqueue", "eval"), ("eval.readback", "eval")}
    # the base was replicated at set-up, outside the profiler
    assert not got.of("eval.replicate")
    assert got.device_s("eval.fold") is None  # timed on the device only on a card
    assert got.counters["eval.place_bytes"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        backend.evaluate_single(dict(base), lora, data, dataset_size=12)  # a new base: a miss
    assert [s.parent for s in take().of("eval.replicate")] == ["eval"]


@pytest.mark.parametrize("grid", [(1, 4), (2, 2), (4, 1)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_place_bytes_match_the_shapes(grid):
    """On a grid of the one CPU device each coalition shard is one piece:
    the padded coalition count times each coalition's bytes."""
    from shapley_vit_tpu_torch.models import vit as tvit
    from shapley_vit_tpu_torch.parallel import mesh as tmesh
    from shapley_vit_tpu_torch.parallel.coalition_eval import make_sharded_coalition_evaluator

    spec = tvit.make_spec("micro")
    g = torch.Generator().manual_seed(0)
    C = 7
    stacked = {"q": torch.randn(C, 2, 16, 16, generator=g),
               "v": torch.randn(C, 2, 16, 16, generator=g).to(torch.bfloat16)}
    fwd = lambda b, m, x: (x.flatten(1)[:, :4] + m["q"].float().mean()  # noqa: E731
                           + m["v"].float().mean())[None].expand(m["q"].shape[0], -1, -1)
    evaluate = make_sharded_coalition_evaluator(
        fwd, tmesh.make_mesh(*grid, ["cpu"] * (grid[0] * grid[1])))
    images = torch.randn(6, spec.image, spec.image, 3, generator=g)
    labels = torch.randint(0, 4, (6,), generator=g)
    with profile(activities=[ProfilerActivity.CPU]):
        evaluate({}, stacked, [(images, labels)])
    padded = -(-C // grid[0]) * grid[0]
    per_coalition = 2 * 16 * 16 * 4 + 2 * 16 * 16 * 2
    assert take().counters["eval.place_bytes"] == padded * per_coalition


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_span_adds_no_device_event_and_reads_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    a = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("work", device=dev):
            for _ in range(4):
                a = (a @ a).tanh()
        torch.cuda.synchronize(dev)
    got = take()
    assert got.device_s("work") > 0
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_events  # the products ran on the card
    assert not [e.name for e in device_events if e.name.startswith(profiling.SPAN_PREFIX)]
    assert "svt.work" in _names(prof.events())
