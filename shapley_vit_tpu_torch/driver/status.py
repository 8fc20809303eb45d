"""``svt-torch-status``: one-glance operator view of a service's experiment dir.

The port of ``shapley_vit_tpu/driver/status.py``, reading the port's own
``driver/protocol.py`` (the same file names, so it reads either package's
output directory).

Reads only the on-disk artifacts (the restart cursor, the round CSV, the
DRAIN flag), so it is safe to run while the service is live on another
host and needs none of the framework stack (import-light, like the
supervisor — this is a stdlib-only module).

The reference has no service and no status surface (its driver prints and
exits, start.py:134-222); this pairs with serve()/svt-torch-supervise.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import Dict, List, Optional

from shapley_vit_tpu_torch.driver.protocol import (
    DRAIN_FILENAME,
    STATE_FILENAME,
    read_service_state,
)


def collect_status(out_dir: str, last: int = 3) -> Dict:
    """The machine-readable status dict ``main`` renders: the persisted
    cursor (plus its file age), the drain flag, and the most recent
    ``last`` rounds' Shapley values grouped from ``shapley_round.csv``."""
    status: Dict = {"out_dir": out_dir}
    state = read_service_state(out_dir)
    status["state"] = state
    path = os.path.join(out_dir, STATE_FILENAME)
    try:
        status["state_age_s"] = round(time.time() - os.path.getmtime(path), 1)
    except OSError:
        status["state_age_s"] = None
    status["drain_requested"] = os.path.exists(
        os.path.join(out_dir, DRAIN_FILENAME)
    )

    rounds: Dict[str, Dict[str, Dict[str, float]]] = {}
    try:
        with open(os.path.join(out_dir, "shapley_round.csv")) as f:
            for row in csv.DictReader(f):
                # the service appends in place (not atomic), so a live read
                # can see a torn last line — skip any row that does not
                # parse instead of crashing the status view
                try:
                    rnd = str(int(row["round"]))
                    val = float(row["shapley_value"])
                    dim, cid = row["utility"], row["client_id"]
                except (KeyError, TypeError, ValueError):
                    continue
                if dim is None or cid is None:
                    continue
                rounds.setdefault(rnd, {}).setdefault(dim, {})[cid] = val
    except (OSError, csv.Error, UnicodeDecodeError):
        # csv.Error covers reader-level corruption the per-row guard never
        # sees (e.g. a NUL-padded tail after a power loss: DictReader
        # raises "line contains NUL" from inside iteration) — the status
        # view must stay usable on whatever rounds parsed before the tear
        pass
    keys = sorted(rounds, key=int)[-last:] if rounds and last > 0 else []
    status["recent_rounds"] = {k: rounds[k] for k in keys}
    status["rounds_on_disk"] = len(rounds)
    return status


def render(status: Dict, out=sys.stdout) -> None:
    w = out.write
    w(f"service dir: {status['out_dir']}\n")
    state = status["state"]
    if state is None:
        w("cursor: none (no round has persisted yet)\n")
    else:
        age = status["state_age_s"]
        w(
            "cursor: next_epoch={next} last_epoch={last} generation={gen} "
            "total_rounds={tot}\n".format(
                next=state.get("next_epoch"), last=state.get("last_epoch"),
                gen=state.get("generation", 1),
                tot=state.get("total_rounds", state.get("rounds")),
            )
        )
        line = (
            f"        stop_reason={state.get('stop_reason', '(running)')} "
            f"rss_mb={state.get('rss_mb', '?')}"
        )
        if age is not None:
            line += f" updated {age}s ago"
        w(line + "\n")
    if status["drain_requested"]:
        w("DRAIN requested (file present) — service stops at the next "
          "round boundary\n")
    w(f"rounds on disk: {status['rounds_on_disk']}\n")
    for rnd, dims in status["recent_rounds"].items():
        for dim, clients in dims.items():
            vals = ", ".join(
                f"c{c}={clients[c]:+.5f}" for c in sorted(clients, key=int)
            )
            w(f"  round {rnd} [{dim}]: {vals}\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="svt-torch-status",
        description="Show a Shapley service's cursor, lineage, and recent "
                    "round results from its experiment dir (safe while the "
                    "service runs).",
    )
    ap.add_argument("out_dir", nargs="?", default=None,
                    help="experiment output dir (<exp_dir>/<exp_id>); "
                         "defaults to --exp-dir/--exp-id")
    ap.add_argument("--exp-dir", default="exp")
    ap.add_argument("--exp-id", default="default")
    ap.add_argument("--last", type=int, default=3,
                    help="how many recent rounds to print (default 3)")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw status dict as one JSON line")
    ns = ap.parse_args(argv)
    out_dir = ns.out_dir or os.path.join(ns.exp_dir, ns.exp_id)
    status = collect_status(out_dir, last=ns.last)
    if ns.json:
        import json

        print(json.dumps(status))
    else:
        render(status)
    # non-zero when there is nothing there at all — scripts can probe
    return 0 if (status["state"] is not None or status["rounds_on_disk"]) else 1


if __name__ == "__main__":
    sys.exit(main())
