"""Each cell's command end to end: without a card it fails and prints no
result; in a directory that holds only the benchmark it fails; and each
cell's traffic kind, driven in-process at a tiny size on the CPU, prints a
result line of the required shape, traced and not."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port.lib import cell
from conftest import BENCH, ROOT, run_tiny, tiny_context

CELLS = [w["name"] for w in cell.load_benchmark(ROOT)["workloads"]]


def _command(workload, cwd):
    bench = cell.load_benchmark(ROOT)
    cmd = [sys.executable] + bench["command"][1:]
    cmd += ["--workload", workload, "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return isinstance(json.loads(lines[-1]), dict)
    except json.JSONDecodeError:
        return False


@pytest.mark.parametrize("workload", CELLS)
def test_command_without_a_card_fails_with_no_result(workload):
    out = _command(workload, ROOT)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "no result" in out.stderr


def test_command_in_a_benchmark_only_checkout_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(CELLS[0], tmp_path)
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "shapley_vit_tpu_torch" in out.stderr


def _shape(line, ctx):
    bench = cell.load_benchmark(ROOT)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    if ctx.trace:
        want = {m["name"] for m in cell.per_layer_of(bench, ctx.cell["name"])}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in cell.end_to_end_of(bench, ctx.cell["name"])}
    # CPU runs have no device trace: the device-trace readers find nothing
    host = {m["name"] for m in bench["end_to_end"] + bench["per_layer"] if m["source"] != "device_trace"}
    assert want & host <= set(line["metrics"]) <= want
    for v in line["metrics"].values():
        assert v["value"] > 0
    json.dumps(line)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_in_process_at_tiny_size(workload, trace, one_thread):
    ctx = tiny_context(workload, trace=bool(trace))
    out, line = run_tiny(ctx)
    _shape(line, ctx)
    assert set(line["checks"]) == set(ctx.limits)
    assert out.readings


def test_same_seed_same_inputs():
    from bench_port.lib import inputs

    ctx = tiny_context(CELLS[0])
    fam = ctx.family()
    a = fam.base(ctx.config, inputs.generator(2**31 + 1, "cpu"), "cpu")
    b = fam.base(ctx.config, inputs.generator(2**31 + 1, "cpu"), "cpu")
    c = fam.base(ctx.config, inputs.generator(2**31 + 2, "cpu"), "cpu")
    assert (a["blocks"]["mlp"]["fc1"]["kernel"] == b["blocks"]["mlp"]["fc1"]["kernel"]).all()
    assert not (a["blocks"]["mlp"]["fc1"]["kernel"] == c["blocks"]["mlp"]["fc1"]["kernel"]).all()


@pytest.mark.parametrize("busy,window,want", [(0.9, 1.0, 10.0), (1.0, 1.0, 0.0), (1.2, 1.0, None),
                                              (0.0, 1.0, None)])
def test_idle_reader_reads_the_trace_alone(busy, window, want):
    """The idle share is the trace's own: one minus its busy seconds over its
    window. A trace busier than its window is a fault of the reduction and
    gives no reading, never a share cut to 0."""
    from bench_port.lib.trace import TraceSummary

    t = TraceSummary(window_s=window, busy_s=busy, by_name={}, by_group={}, idle_by_host={})
    rec = cell.Record(cell={}, config={}, mix={}, chips=1, facts={"window_s": 50.0, "rounds": 100},
                      trace=t)
    for name in ("idle_pct.eval", "idle_pct.eval_mesh4", "idle_pct.train"):
        got = cell.metric_reader(name)(rec)
        assert got == pytest.approx(want) if want is not None else got is None
