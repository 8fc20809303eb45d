"""The readers of the program's spans and counters (``lib/spans.py`` and
the seven metrics over it): their arithmetic on a synthetic buffer (self
time, per traced round, None without the span), one drain per run, no
reading from a program without the buffer, and the metrics in a traced
tiny run on the CPU."""

import dataclasses

import pytest

from bench_port.lib import cell, spans
from conftest import run_tiny, tiny_context

MS = 1_000_000  # nanoseconds


def _buffer():
    from shapley_vit_tpu_torch.utils.profiling import SpanRecord, Spans

    def rec(name, parent, t0, t1, child=0, device_s=None):
        return SpanRecord(name, parent, 1, t0 * MS, t1 * MS, child * MS, device_s)

    records = []
    for r in range(2):  # two traced rounds
        o = 1000 * r
        records += [
            rec("tree.stack_host", None, o, o + 6),
            rec("tree.to_device", None, o + 6, o + 10),
            rec("eval.fold", "game.evaluate", o + 12, o + 13, device_s=0.0015),
            rec("eval.place", "eval", o + 13, o + 23),
            rec("eval.enqueue", "eval", o + 23, o + 30),
            rec("eval.readback", "eval", o + 30, o + 400),
            rec("eval", "game.evaluate", o + 13, o + 401, child=387),
            rec("game.evaluate", "estimator", o + 11, o + 402, child=389),
            rec("estimator", None, o + 10, o + 405, child=391),
        ]
    return Spans(records, {"eval.place_bytes": 2 * 0.878e9}, 0)


def _record(buffer, rounds=2):
    return cell.Record(cell={}, config={}, mix={}, chips=1,
                       facts={"traced_rounds": rounds, spans.KEY: buffer}, trace=None)


# metric: its reading per traced round from the synthetic buffer
WANT = {
    "upload_ms_per_round": 10.0,         # self of stack (6) + upload (4)
    "estimator_ms_per_round": 4.0,       # 395 less game.evaluate's 391
    "fold_ms_per_round": 1.5,            # the CUDA events' 1.5 ms
    "place_ms_per_round.mesh4": 10.0,
    "place_gb_per_round.mesh4": 0.878,
    "enqueue_ms_per_round.mesh4": 7.0,
    "readback_ms_per_round.mesh4": 370.0,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_arithmetic(metric):
    read = cell.metric_reader(metric)
    assert read(_record(_buffer())) == pytest.approx(WANT[metric])
    # per traced round: the same buffer over four rounds reads half
    assert read(_record(_buffer(), rounds=4)) == pytest.approx(WANT[metric] / 2)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_its_span_reads_nothing(metric):
    from shapley_vit_tpu_torch.utils.profiling import Spans

    read = cell.metric_reader(metric)
    assert read(_record(Spans([], {}, 0))) is None
    assert read(_record(None)) is None
    untraced = cell.Record(cell={}, config={}, mix={}, chips=1, facts={}, trace=None)
    assert read(untraced) is None


def test_fold_without_device_time_reads_nothing():
    from shapley_vit_tpu_torch.utils.profiling import Spans

    b = _buffer()
    on_cpu = Spans([s for s in b.spans if s.name != "eval.fold"]
                   + [dataclasses.replace(s, device_s=None) for s in b.of("eval.fold")],
                   b.counters, 0)
    assert cell.metric_reader("fold_ms_per_round")(_record(on_cpu)) is None


def test_buffer_is_drained_once_per_run(monkeypatch):
    from shapley_vit_tpu_torch.utils import profiling

    calls = []
    monkeypatch.setattr(profiling, "take", lambda: calls.append(1) or _buffer())
    rec = cell.Record(cell={}, config={}, mix={}, chips=1, facts={"traced_rounds": 2}, trace=None)
    for metric in sorted(WANT):
        assert cell.metric_reader(metric)(rec) == pytest.approx(WANT[metric])
    assert len(calls) == 1


def test_program_without_the_buffer_reads_nothing(monkeypatch):
    """The parent of the change that added the spans has no ``take``: every
    reader gives nothing and none raises."""
    from shapley_vit_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "take")
    rec = cell.Record(cell={}, config={}, mix={}, chips=1, facts={"traced_rounds": 8}, trace=None)
    for metric in sorted(WANT):
        assert cell.metric_reader(metric)(rec) is None


@pytest.mark.parametrize("workload,metrics", [
    ("vitb16-n3", ["upload_ms_per_round", "estimator_ms_per_round"]),
    ("vitb16-n5-mesh4", ["place_ms_per_round.mesh4", "place_gb_per_round.mesh4",
                         "enqueue_ms_per_round.mesh4", "readback_ms_per_round.mesh4"]),
])
def test_traced_tiny_run_reads_the_program_spans(workload, metrics, one_thread):
    _, line = run_tiny(tiny_context(workload, trace=True))
    for m in metrics:
        assert line["metrics"][m]["value"] > 0
    assert "fold_ms_per_round" not in line["metrics"]  # no CUDA events on the CPU
    assert not [n for n, _ in line["breakdown"]["device_ops"] if n.startswith("svt.")]
