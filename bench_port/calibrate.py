"""Readings that the correctness limits are set from, many seeds in one
process on the card (the benchmark's own runs never run this):

    python3 bench_port/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control] [--rounds 4] [--steps 2] > readings.jsonl

For each seed, one JSON line with the compared numbers of a short run of
the cell's timed path against the plain reference (``"mode": "program"``).
With ``--control``, the same numbers of the control, the reference
computed in fp8 put in the program's place (``"fp8"``), and for a training
cell also of the fault that leaves half of each batch out, planted in the
reference put in the program's place (``"half_batch"``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.lib import cell  # noqa: E402

NO_LIMIT = {"limit": float("inf")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--control", action="store_true")
    p.add_argument("--rounds", type=int, default=4, help="window rounds (evaluation cells)")
    p.add_argument("--steps", type=int, default=2, help="window steps (training cells)")
    args = p.parse_args(argv)
    cell.set_cache_env(cell.ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=0.0, trace=0)
        ctx = cell.build_context(ns, time.perf_counter())
        kind = ctx.mix["kind"]
        limits = {k: NO_LIMIT for k in ctx.limits}
        modes = [("program", {})]
        if args.control:
            modes.append(("fp8", {"reference_quant": "fp8"}))
            if kind == "client_train":
                modes.append(("half_batch", {"half_batch": True}))
        for mode, extra in modes:
            ctx.overrides = {"limits": limits, "rounds": args.rounds, "steps": args.steps, **extra}
            ctx.t0 = time.perf_counter()
            out = cell.traffic_kind(kind).run(ctx)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "readings": {k: float(v) for k, v in out.readings.items()},
                              "setup_s": out.facts.get("setup_s"),
                              "images_per_s": out.facts.get("images_per_s"),
                              "memory_peak_bytes": out.memory_peak_bytes}), flush=True)
    leaked = cell.forbidden_loaded()
    if leaked:
        print(f"modules of JAX or of the JAX package are loaded: {leaked}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
