#!/usr/bin/env python3
"""Hold the host-side times of the port's main paths in two checkouts
against each other on one NVIDIA GPU, in alternating runs.

    mkdir -p exp/ab/other && git archive <rev> | tar -x -C exp/ab/other
    python3 tools/torch_host_ab.py exp/ab/other . [--pairs 2] [--out DIR] [--float32-round]

Each run is a fresh process with the checkout's ``shapley_vit_tpu_torch``
first on the path, measured by THIS tree's ``chip_smoke.py`` (the same
measurement code for both): ``phase_round`` (the bf16 round's
``round_s``), ``profile_train_step`` three times (a batch-64 training
step's host clock and device-busy ms), ``phase_serve`` (each round's
``arrival_to_sv_s``) and ``phase_rounds`` (``run_federated_rounds``'
wall). With ``--float32-round`` a run is the float32 round instead
(``phase_round`` at float32, then ``phase_profile``'s pass at float32: its
device time by group), with no check of the fused MLP's route, so that a
checkout whose float32 MLP is another kernel runs it all the same. The
runs go A B B A, ``--pairs`` times. One JSON line per run, then
one with each number's values per checkout; each run's whole output goes
to ``--out`` (default ``exp/host_ab``).
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(checkout: str, float32_round: bool = False) -> None:
    """One run: this tree's chip_smoke measurements on ``checkout``'s package."""
    sys.path.insert(0, os.path.abspath(checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.ops import _build
    from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed

    import shapley_vit_tpu_torch
    print(json.dumps({"package": os.path.dirname(shapley_vit_tpu_torch.__file__)}), flush=True)
    _build.build()
    counted = (patch_embed, fused_attention_packed, fused_mlp_block, fused_attention)
    for fn in counted:  # a checkout whose wrappers count no launches by kernel
        if not hasattr(fn, "launches_by"):
            fn.launches_by = collections.Counter()
    if float32_round:
        cs.phase_round(counted[:3], dtype="float32")
        cs.phase_profile(cs.round_dir("float32"), dtype="float32", mlp_kernel=None)
        return
    cs.phase_round(counted[:3])
    steps = [cs.profile_train_step(Config(), 64) for _ in range(3)]
    print(json.dumps({"phase": "train_steps", "step_ms": [s["step_ms"] for s in steps],
                      "device_busy_ms": [s["device_busy_ms"] for s in steps]}), flush=True)
    cs.phase_serve(counted)
    cs.phase_rounds(counted)


def numbers(lines) -> dict:
    """The compared numbers from one run's JSON lines."""
    got = {}
    for ln in lines:
        if not ln.startswith("{"):
            continue
        try:
            o = json.loads(ln)
        except ValueError:
            continue
        phase = o.get("phase")
        if phase == "round":
            got["round_s"] = [o["round_s"]]
            got["fused_mlp_block_launches"] = [o["launches"]["fused_mlp_block"]]
        elif phase == "profile":
            got["pass_ms"] = [o["pass_ms"]]
            got["device_busy_ms"] = [o["device_busy_ms"]]
            for group, ms in o["device_ms_by_group"].items():
                got[f"{group}_device_ms"] = [ms]
        elif phase == "train_steps":
            got["train_step_host_ms"] = o["step_ms"]
            got["train_step_busy_ms"] = o["device_busy_ms"]
        elif phase == "serve":
            got["serve_arrival_to_sv_s_round0"] = [o["per_round"][0]["arrival_to_sv_s"]]
            got["serve_arrival_to_sv_s_prefetched"] = [o["per_round"][1]["arrival_to_sv_s"]]
        elif phase == "rounds":
            got["rounds_wall_s"] = [o["wall_s"]]
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "exp", "host_ab"))
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--float32-round", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.a, args.float32_round)
        return 0

    os.makedirs(args.out, exist_ok=True)
    order = [args.a, args.b, args.b, args.a] * args.pairs
    per = {args.a: {}, args.b: {}}
    for i, checkout in enumerate(order):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), checkout, checkout,
                              "--child", *(["--float32-round"] if args.float32_round else [])],
                             cwd=ROOT, capture_output=True, text=True)
        with open(os.path.join(args.out, f"run{i}.log"), "w") as f:
            f.write(run.stdout + "\n--- stderr ---\n" + run.stderr)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({checkout}) exited {run.returncode}")
        got = numbers(run.stdout.splitlines())
        print(json.dumps({"run": i, "checkout": checkout, **got}), flush=True)
        for k, v in got.items():
            per[checkout].setdefault(k, []).extend(v)
    print(json.dumps({"a": args.a, "b": args.b, "values": per}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
