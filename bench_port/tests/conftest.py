"""Shared pieces of the benchmark's CPU tests: each configuration at its
model family's tiny sizes (the family's ``TINY``), tiny mixes, and a way to
run a cell's traffic kind in-process on the CPU (the harness's look for a
card skipped; the command itself refuses a machine without one)."""

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.lib import cell  # noqa: E402

_load_benchmark = cell.load_benchmark

# cells whose runners, mixes, limits and readers stay under test, but that
# BENCHMARK.json leaves out (PERF.md, Open questions, says why and what
# would bring each back)
LEFT_OUT = [{"name": "vitb16-train-b64", "config": "vit-b16", "traffic": "train-b64", "chips": 1}]

TINY_MIX = {"shapley_round": dict(eval_batch=16, trace_rounds=2, warmup_rounds=1),
            "client_train": dict(shard_images=48, batch=8, trace_steps=2, warmup_steps=1)}


def benchmark_with_left_out(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` with the cells of ``LEFT_OUT`` added."""
    bench = _load_benchmark(root)
    bench["workloads"] = bench["workloads"] + LEFT_OUT
    return bench


def tiny_context(workload: str, seed: int = 2**31 + 11, trace: bool = False, overrides=None,
                 seconds: float = 0.3, limits=None, config=None):
    """The cell's context at the tiny size on CPU devices (one per card the
    cell asks for): the configuration updated with ``config``, by default
    its family's ``TINY``."""
    import torch

    bench = benchmark_with_left_out()
    c = cell.by_name(bench["workloads"], workload, "workload")
    conf = cell.load_json(os.path.join(ROOT, cell.by_name(bench["configs"], c["config"], "config")["file"]))
    conf.update(cell.family_module(conf["reference"]).TINY if config is None else config)
    mix = cell.load_json(os.path.join(BENCH, "mixes", f"{c['traffic']}.json"))
    mix.update(TINY_MIX[mix["kind"]])
    if limits is None:
        path = os.path.join(BENCH, "limits", f"{workload}.json")
        limits = cell.load_json(path) if os.path.exists(path) else {}
    return cell.Context(root=ROOT, cell=c, config=conf, mix=mix, limits=limits, seed=seed,
                        seconds=seconds, trace=trace,
                        devices=[torch.device("cpu")] * int(c["chips"]),
                        t0=time.perf_counter(), overrides=dict(overrides or {}))


def run_tiny(ctx):
    """Run the cell's kind and build its result line."""
    out = cell.traffic_kind(ctx.mix["kind"]).run(ctx)
    return out, cell.result_line(ctx, out)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
