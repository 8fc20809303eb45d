#!/usr/bin/env python3
"""Coalition evaluation sharded over several GPUs of one host, against one.

    python3 tools/torch_mesh_gpus.py                 # every visible card
    python3 tools/torch_mesh_gpus.py --device cpu    # a rehearsal on the CPU

Two parts, one JSON line each; the script exits non-zero if a check fails.

1. ``grids``: in one process, chip_smoke's round (ViT-B/16, 3 clients, 7
   coalitions, 400 validation images; bf16 and float32) through ``start()``
   on one card (``dist.mesh="off"``), and over every card with
   ``dist.mesh="auto"`` (the grid ``parallel.autoshape`` picks) and with the
   coalition axis forced to 1, 2 and the card count. Each is held against
   the one-card round: accuracies equal, losses within 1e-5 of the loss,
   Shapley values within 1e-4, each wrapper's launches the cell count times
   the one card's, and every card of the grid with memory in use. It
   prints each round's ``round_s``.
2. ``ranks``: ``--procs`` ranks (default: one a card) of one
   ``torch.distributed`` world (nccl), one card each, run one ``serve()``
   round over a shared directory on the same drops. Every rank's Shapley
   values are held within 1e-4 of a one-process ``serve()`` on one card,
   only rank 0 may return artifacts, and each rank, which names no
   ``devices``, allocates on its own card alone.

``--device cpu`` runs both parts at the micro ViT (16 px, float32) on the
CPU: the grids repeat the CPU device (``devices=["cpu"] * 4``), the ranks use
gloo, and the launch and memory checks are left out (the plain versions
run there). Outputs go under ``exp/mesh_gpus/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "exp", "mesh_gpus")


def config(device: str, out: str, dtype: str = "bfloat16"):
    from shapley_vit_tpu_torch.config import Config

    cfg = Config()  # ViT-B/16, merged, comp-contrib
    cfg.model.compute_dtype = dtype
    if device == "cpu":
        cfg.model.vit_variant, cfg.model.compute_dtype = "micro", "float32"
        cfg.data.synthetic_scale, cfg.data.eval_batch_size = 0.1, 16
    cfg.obs.exp_dir = out
    cfg.obs.render_plots = False  # no matplotlib on the card's machine
    return cfg


def write_drops(cfg, root: str, filename: str) -> list:
    """chip_smoke's three client drops (seed 7) under ``root``."""
    import numpy as np

    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.fl import ingestion
    from shapley_vit_tpu_torch.models.convert import tree_to_numpy
    from shapley_vit_tpu_torch.ops import tree_math as tm

    spec, _, init_lora = drv.build_model(cfg, device="cpu")
    init_host = tree_to_numpy(init_lora)
    rng = np.random.default_rng(7)
    paths = []
    for i, n_train in enumerate((120, 300, 580)):
        drop = tm.tree_map(lambda a: a + (0.02 * rng.normal(size=a.shape)).astype(np.float32),
                           init_host)
        p = os.path.join(root, f"client_{i + 1}_model", filename)
        ingestion.save_lora_checkpoint(p, drop, spec, num_local_data_train=n_train)
        paths.append(p)
    return paths


def part_grids(device: str) -> bool:
    import torch

    import chip_smoke as cs
    from shapley_vit_tpu_torch.driver import start as drv
    from shapley_vit_tpu_torch.ops.attention import fused_attention_packed
    from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
    from shapley_vit_tpu_torch.ops.patch_embed import patch_embed
    from shapley_vit_tpu_torch.parallel.mesh import local_devices

    counted = (patch_embed, fused_attention_packed, fused_mlp_block)
    cards = local_devices(device) if device == "cuda" else [torch.device("cpu")] * 4
    n = len(cards)
    if device == "cuda":
        for c in cards:  # each card's allocator exists before its stats are reset
            torch.zeros(1, device=c)
    work = os.path.join(WORK, "grids")
    shutil.rmtree(work, ignore_errors=True)
    paths = write_drops(config(device, work), work, "ViT_epoch_9.npz")
    runs = [("one card", "off", 0), ("auto", "auto", 0),
            (f"1x{n}", "auto", 1), (f"2x{n // 2}", "auto", 2), (f"{n}x1", "auto", n)]
    rows, ok = [], True
    for dtype in (("bfloat16", "float32") if device == "cuda" else ("float32",)):
        single = None
        for name, mode, shards in runs:
            cfg = config(device, os.path.join(work, f"{dtype}_{name.replace(' ', '_')}"), dtype)
            cfg.dist.mesh, cfg.dist.mesh_coalition_shards = mode, shards
            devices = cards[:1] if mode == "off" else cards
            cs.zero_counts(counted)
            if device == "cuda":
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
            t0 = time.perf_counter()
            all_rounds, _ = drv.start(cfg, checkpoint_paths=paths, device=device,
                                      devices=devices)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = cs.round_result(cfg, all_rounds, {fn.__name__: fn.launches for fn in counted})
            round_s = cs._metric(os.path.join(
                cfg.output_dir, f"party0_{cfg.obs.exp_id}_{cfg.data.mode}_metrics.csv"),
                "time/shapley_round")
            row = {"dtype": dtype, "grid": name, "round_s": round_s, "wall_s": wall,
                   "launches": got["launches"]}
            if device == "cuda":
                row["peak_gb"] = [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards]
            if single is None:
                single = got
            else:
                loss0 = abs(single["sv"][1][0][0]) * 3
                row["accuracies_equal"] = (got["sv"][0][0] == single["sv"][0][0] and all(
                    got["table"][k][0] == single["table"][k][0] for k in single["table"]))
                row["max_loss_err"] = max(abs(got["table"][k][1] - single["table"][k][1])
                                          for k in single["table"])
                row["max_sv_err"] = max(abs(a - b) for d in (0, 1) for r in (0, 1)
                                        for a, b in zip(got["sv"][d][r], single["sv"][d][r]))
                row["ok"] = (row["accuracies_equal"] and row["max_loss_err"] <= 1e-5 * loss0
                             and row["max_sv_err"] <= 1e-4)
                if device == "cuda":
                    row["ok"] = (row["ok"] and all(
                        got["launches"][k] == n * single["launches"][k] > 0
                        for k in got["launches"]) and all(g > 0 for g in row["peak_gb"]))
                ok = ok and row["ok"]
            rows.append(row)
    print(json.dumps({"part": "grids", "device": device, "cards": [str(c) for c in cards],
                      "rows": rows, "ok": ok}), flush=True)
    return ok


def serve_round(device: str, work: str, rank_device: str, mesh: str):
    """One ``serve()`` round over ``work`` on ``rank_device``, with the
    drivers' default evaluation devices (a rank's own card in a world)."""
    from shapley_vit_tpu_torch.driver import serve as svc

    cfg = config(device, os.path.join(work, "out" if mesh != "off" else "one"))
    cfg.paths.local_model_path = os.path.join(work, "local")
    cfg.paths.global_model_path = os.path.join(cfg.obs.exp_dir, "global")
    cfg.dist.mesh = mesh
    t0 = time.perf_counter()
    records = svc.serve(cfg, max_rounds=1, timeout=300.0, policy="fail", device=rank_device)
    sv = [[records[0]["shapley"][d][c] for c in range(3)] for d in (0, 1)]
    return sv, records[0], time.perf_counter() - t0


def part_ranks(device: str, procs: int) -> bool:
    work = os.path.join(WORK, "ranks")
    shutil.rmtree(work, ignore_errors=True)
    write_drops(config(device, work), os.path.join(work, "local"), "ViT_epoch_0.pth.tar")
    first = "cuda:0" if device == "cuda" else "cpu"
    one, rec, one_wall = serve_round(device, work, first, "off")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", device, "--procs", str(procs),
         "--rank", str(r), "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(procs)]
    outs = []
    try:
        for p in children:
            outs.append(p.communicate(timeout=900)[0])
    finally:
        for p in children:
            p.kill()
    ranks, ok = [], True
    for r, (p, out) in enumerate(zip(children, outs)):
        line = [x for x in out.splitlines() if x.startswith('{"rank"')]
        if p.returncode != 0 or not line:
            print(out[-3000:], file=sys.stderr)
            ranks.append({"rank": r, "returncode": p.returncode})
            ok = False
            continue
        got = json.loads(line[-1])
        got["max_sv_err"] = max(abs(a - b) for d in (0, 1) for a, b in zip(got["sv"][d], one[d]))
        got["ok"] = (got["max_sv_err"] <= 1e-4 and (r == 0) == (got["artifacts"] > 0)
                     and got["cards_used"] == ([r] if device == "cuda" else []))
        ok = ok and got["ok"]
        ranks.append(got)
    print(json.dumps({"part": "ranks", "device": device, "procs": procs,
                      "one_process": {"wall_s": one_wall, "round_wall_s": rec["wall_s"],
                                      "sv": one},
                      "ranks": ranks, "ok": ok}), flush=True)
    return ok


def child(device: str, procs: int, rank: int, port: int) -> None:
    import torch

    from shapley_vit_tpu_torch.config import DistConfig
    from shapley_vit_tpu_torch.parallel import distributed as pdist

    if device == "cuda":
        torch.cuda.set_device(rank)
    assert pdist.initialize_from_config(
        DistConfig(dist_num=procs, dist_rank=rank, master_addr="127.0.0.1", master_port=port),
        device=device)
    rank_device = f"cuda:{rank}" if device == "cuda" else "cpu"
    sv, rec, wall = serve_round(device, os.path.join(WORK, "ranks"), rank_device, "auto")
    # the cards this process allocated on: its own alone
    used = ([i for i in range(torch.cuda.device_count()) if torch.cuda.max_memory_allocated(i)]
            if device == "cuda" else [])
    print(json.dumps({"rank": rank, "device": rank_device, "sv": sv, "wall_s": wall,
                      "round_wall_s": rec["wall_s"], "artifacts": len(rec["artifacts"]),
                      "cards_used": used}), flush=True)
    torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--procs", type=int, default=0, help="ranks of part 2 (default: the cards)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_mesh_gpus: no CUDA device", file=sys.stderr)
        return 2
    procs = args.procs or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if args.rank is not None:
        child(args.device, procs, args.rank, args.port)
        return 0
    if args.device == "cuda":
        from shapley_vit_tpu_torch.ops import _build

        _build.build()
    ok = part_grids(args.device)
    ok = part_ranks(args.device, procs) and ok
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
