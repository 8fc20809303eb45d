"""The harness's frame: find a cell by its name in ``BENCHMARK.json``, check
the machine, run the cell's traffic kind, read the cell's metrics and print
the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
lives in a file of its own, found by name:

* ``bench_port/configs/<config>.json``   the configuration as it is run
  (widths, numerics, its plain reference and model family under
  ``"reference"``);
* ``bench_port/mixes/<traffic>.json``    a traffic mix: its ``"kind"`` and
  the parameters that kind's runner reads;
* ``bench_port/traffic/<kind>.py``       a traffic kind's runner, with
  ``run(ctx) -> Outcome``;
* ``bench_port/metrics/<metric>.py``     a metric's reader, with
  ``read(rec) -> float | None``;
* ``bench_port/limits/<cell>.json``      the limits of the cell's
  correctness check, each with the readings it was set from;
* ``bench_port/references/<name>.py``    a plain reference;
* ``bench_port/families/<name>.py``      a model family: the program's spec,
  the base weights, the counts of its work, its kernel wrappers and names,
  found by the same ``"reference"`` name.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries, without editing a file that is there.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# whole top-level module names that may not be loaded in a run: JAX and the
# JAX package (the port's name begins with the latter's, so a prefix test
# would be wrong)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "shapley_vit_tpu")

# caches the program or torch may write, kept inside the checkout at fixed
# paths so that only the first run of a cell builds
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}
CACHE_ROOT = ".bench_port_cache"


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: str, name: str):
    """A module from a file path (metric readers carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return load_module(path, "bench_port_metric_" + name.replace(".", "_").replace("-", "_")).read


def traffic_kind(kind: str):
    return importlib.import_module(f"bench_port.traffic.{kind}")


def reference_module(name: str):
    return importlib.import_module(f"bench_port.references.{name}")


def family_module(name: str):
    return importlib.import_module(f"bench_port.families.{name}")


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_of(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those that list it, and those
    with no ``workloads`` key (``setup_s``)."""
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a ``workloads`` key whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_loaded(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose whole top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m, v in list(modules.items())
                  if v is not None and m.split(".")[0] in FORBIDDEN_MODULES)


def set_cache_env(root: str) -> None:
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, CACHE_ROOT, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def card_devices(chips: int) -> list:
    """The first ``chips`` CUDA devices; raises :class:`NoDevice` when the
    machine has fewer. Never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards and torch sees {torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(chips)]


@dataclass
class Context:
    """What a traffic kind's runner gets: the cell and its files, the run's
    arguments, and the devices it may use."""

    root: str
    cell: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    devices: list
    t0: float                      # perf_counter at process start
    overrides: dict = field(default_factory=dict)  # calibration and tests only

    def reference(self):
        return reference_module(self.config["reference"])

    def family(self):
        return family_module(self.config["reference"])


@dataclass
class Outcome:
    """What a traffic kind's runner returns. ``facts`` holds the numbers the
    metric readers read; ``checks`` each compared number as ``(value,
    limit)``; ``trace`` the summary of the traced window, or None."""

    facts: Dict[str, Any]
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None
    readings: Dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        # a run that compared nothing is never correct
        return bool(self.checks) and self.failed == 0 and all(
            v is not None and math.isfinite(v) and v <= lim for v, lim in self.checks.values())


@dataclass
class Record:
    """What a metric reader reads."""

    cell: dict
    config: dict
    mix: dict
    chips: int
    facts: Dict[str, Any]
    trace: Any


def device_info(devices, outcome: Outcome, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices), "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace:
        t = outcome.trace
        info["busy_s"] = t.busy_s if t is not None else 0.0
        info["window_s"] = t.window_s if t is not None else 0.0
    return info


def read_metrics(entries: List[dict], rec: Record) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def build_context(args, t0: float, devices=None, root: str = ROOT, overrides=None) -> Context:
    bench = load_benchmark(root)
    cell = by_name(bench["workloads"], args.workload, "workload")
    conf_entry = by_name(bench["configs"], cell["config"], "config")
    config = load_json(os.path.join(root, conf_entry["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "mixes", f"{cell['traffic']}.json"))
    limits_path = os.path.join(BENCH_DIR, "limits", f"{cell['name']}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    if devices is None:
        devices = card_devices(int(cell["chips"]))
    return Context(root=root, cell=cell, config=config, mix=mix, limits=limits,
                   seed=int(args.seed), seconds=float(args.seconds), trace=bool(args.trace),
                   devices=devices, t0=t0, overrides=dict(overrides or {}))


def result_line(ctx: Context, outcome: Outcome, bench: Optional[dict] = None) -> dict:
    bench = bench if bench is not None else load_benchmark(ctx.root)
    name = ctx.cell["name"]
    entries = per_layer_of(bench, name) if ctx.trace else end_to_end_of(bench, name)
    rec = Record(cell=ctx.cell, config=ctx.config, mix=ctx.mix, chips=len(ctx.devices),
                 facts=outcome.facts, trace=outcome.trace)
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": read_metrics(entries, rec)}
    if ctx.devices and ctx.devices[0].type == "cuda":
        line["device"] = device_info(ctx.devices, outcome, ctx.trace)
    else:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": len(ctx.devices),
                          "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if ctx.trace and outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    set_cache_env(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    import shapley_vit_tpu_torch  # noqa: F401  (the program: a checkout without it has no result)

    try:
        ctx = build_context(args, t0)
    except NoDevice as e:
        log(f"no result: {e}")
        return 3
    outcome = traffic_kind(ctx.mix["kind"]).run(ctx)
    line = result_line(ctx, outcome)
    leaked = forbidden_loaded()
    if leaked:
        log(f"no result: modules of JAX or of the JAX package are loaded: {leaked}")
        return 4
    for k, v in outcome.readings.items():
        if k not in outcome.checks:
            log(f"reading {k}: {v!r} (not compared)")
    for k, (v, lim) in outcome.checks.items():
        log(f"check {k}: {v!r} (limit {lim!r}) {'ok' if v is not None and v <= lim else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0
