"""The controls at the cells' own sizes, on the card (marked ``cuda``; they
skip on a machine without one):

    python -m pytest -q -m cuda bench_port/tests/test_bench_port_card.py

For each cell, on one seed: the bf16 program's short run is
correct by the cell's limits, and the control, the reference computed in
fp8 in the program's place, is not. ``calibrate.py --control`` reads the
same numbers over many seeds."""

import argparse
import time

import pytest

from bench_port.lib import cell
from conftest import benchmark_with_left_out

NO_LIMIT = {"limit": float("inf")}


def _card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")


def _readings(workload: str, seed: int, **extra) -> tuple:
    ns = argparse.Namespace(workload=workload, seed=seed, seconds=0.0, trace=0)
    ctx = cell.build_context(ns, time.perf_counter())
    limits = dict(ctx.limits)
    ctx.overrides = {"limits": {k: NO_LIMIT for k in limits}, "rounds": 4, "steps": 2, **extra}
    out = cell.traffic_kind(ctx.mix["kind"]).run(ctx)
    return out.readings, limits


@pytest.mark.cuda
@pytest.mark.parametrize("workload,chips", [("vitb16-n3", 1), ("vitl16-n3", 1), ("vitb16-train-b64", 1),
                                            ("vitb16-n5-mesh4", 4)])
def test_fp8_control_fails_where_the_program_passes(workload, chips, monkeypatch):
    _card(chips)
    monkeypatch.setattr(cell, "load_benchmark", benchmark_with_left_out)
    seed = 2**31 + 977
    sound, limits = _readings(workload, seed)
    control, _ = _readings(workload, seed, reference_quant="fp8")
    assert all(sound[k] <= v["limit"] for k, v in limits.items()), sound
    assert any(control[k] > v["limit"] for k, v in limits.items()), control
