"""End-to-end Shapley service demo with trained client deltas (the port of
``examples/serve_demo.py``).

The deployment's shape (reference start.py:134-222 and the FL trainer
outside it): clients fine-tune LoRA on their own non-IID shards and drop
checkpoints through the atomic-rename protocol; the Shapley service
(``driver/serve.py``) watches, ingests, runs a round and exports the new
global overlay; the clients resume from that global for the next epoch.
The SV trajectories over the epochs go to ``sv_trajectory.png``.

    python -m shapley_vit_tpu_torch.examples.serve_demo [--epochs 3] [--clients 3]
        [--device cuda|cpu]

The card by default (ViT-B/16 at 224 px); ``--device cpu`` runs the micro
ViT at 16 px. The clients train on a thread of their own while ``serve()``
runs on the caller's: both launch kernels, and the wrappers load each
library once and count launches under locks (``ops/_build.py``). A client
thread that raises stops the service (a drain) and fails the demo.

Where matplotlib does not import, the trajectory is drawn as plain lines on
a white canvas and written by ``utils.tb_events.encode_png`` (and the
service's own per-round plots are off).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile
import threading
from typing import List, Optional

import numpy as np
import torch

from shapley_vit_tpu_torch.config import Config
from shapley_vit_tpu_torch.data.partition import partition_labeldir
from shapley_vit_tpu_torch.data.registry import get_dataset
from shapley_vit_tpu_torch.driver import serve as svc
from shapley_vit_tpu_torch.driver import start as start_mod
from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
from shapley_vit_tpu_torch.fl import ingestion
from shapley_vit_tpu_torch.fl import training as tr
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.models.convert import tree_from_numpy


def _has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def demo_config(variant: str = "micro", image_size: int = 16, synthetic_scale: float = 0.02,
                out_dir: Optional[str] = None) -> Config:
    """The demo's configuration (JAX's defaults: micro at 16 px, evaluation
    batch 32, the synthetic OCT layout at 2 %), writing under ``out_dir``
    (a fresh temporary directory by default)."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="svt_serve_demo_")
    cfg = Config()
    cfg.model.vit_variant = variant
    cfg.model.model_type = f"ViT-{variant}"
    cfg.data.image_size = image_size
    cfg.data.eval_batch_size = 32
    cfg.data.synthetic_scale = synthetic_scale
    cfg.obs.exp_dir = os.path.join(out_dir, "exp")
    cfg.obs.render_plots = _has_matplotlib()
    cfg.paths.validation_dataset = ""  # synthetic OCT
    cfg.paths.local_model_path = os.path.join(out_dir, "local")
    cfg.paths.global_model_path = os.path.join(out_dir, "global")
    return cfg


def _raster_trajectory(svs, path: str, dim: int = 0, size=(240, 320)) -> None:
    """Each client's SV over the rounds as a polyline on a white canvas
    (a dark frame, the zero line in grey), written as a PNG."""
    from shapley_vit_tpu_torch.utils.tb_events import encode_png

    h, w = size
    img = np.ones((h, w, 3), np.float32)
    img[[0, -1], :], img[:, [0, -1]] = 0.2, 0.2
    clients = sorted({c for sv in svs for c in sv[dim]})
    values = np.array([[sv[dim].get(c, 0.0) for c in clients] for sv in svs])
    lo, hi = min(values.min(), 0.0), max(values.max(), 0.0)
    span = hi - lo if hi > lo else 1.0

    def y_of(v):
        return int(round((h - 11) - (v - lo) / span * (h - 21)))

    img[y_of(0.0), 1:-1] = 0.7
    xs = np.linspace(10, w - 11, max(len(svs), 2))
    colors = [(0.12, 0.47, 0.71), (1.0, 0.5, 0.05), (0.17, 0.63, 0.17), (0.84, 0.15, 0.16),
              (0.58, 0.4, 0.74)]
    for j in range(len(clients)):
        for r in range(len(svs) - 1):
            for t in np.linspace(0.0, 1.0, 200):
                x = int(round(xs[r] + t * (xs[r + 1] - xs[r])))
                y = y_of(values[r, j] + t * (values[r + 1, j] - values[r, j]))
                img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = colors[j % len(colors)]
    with open(path, "wb") as f:
        f.write(encode_png(img))


def plot_trajectory(svs, path: str) -> None:
    """``report.plot_shapley_rounds`` where matplotlib imports, else the
    plain raster."""
    if _has_matplotlib():
        from shapley_vit_tpu_torch.driver.report import plot_shapley_rounds

        plot_shapley_rounds(svs, path)
    else:
        _raster_trajectory(svs, path)


def run_demo(cfg: Optional[Config] = None, epochs: int = 3, n_clients: int = 3,
             local_steps: int = 4, device=None):
    """Run the trained-delta service loop; returns (records, out_dir)."""
    device = start_mod.resolve_device(device)
    cfg = cfg or demo_config()
    if not (cfg.paths.local_model_path and cfg.paths.global_model_path):
        raise ValueError("the demo needs LOCAL_MODEL_PATH and GLOBAL_MODEL_PATH")
    # the service watches and scores cfg.shapley.num_clients clients: keep it
    # in step with the trainer fleet or the round never completes
    cfg.shapley.num_clients = n_clients

    spec, base, init_lora = start_mod.build_model(cfg, device=device)
    spec = spec.replace(**TRAIN_SPEC)

    # non-IID Dirichlet shards of the (synthetic) OCT training split
    splits, info = get_dataset(cfg.data.dataset_type, data_dir=cfg.paths.validation_dataset,
                               synthetic_scale=cfg.data.synthetic_scale)
    train = splits["train"]
    _, mapping = partition_labeldir(train.labels, num_classes=info["num_classes"],
                                    n_parties=n_clients, beta=0.5)
    shard = []
    for c in range(n_clients):
        idx = mapping[c][:64]
        x = train.images[idx]
        if x.shape[1] != spec.image:
            x = start_mod.resize_images(x, spec.image, device=device)
        shard.append((torch.as_tensor(x, dtype=torch.float32, device=device),
                      torch.as_tensor(train.labels[idx], device=device)))
    sizes = [len(mapping[c]) for c in range(n_clients)]

    opt = tr.adam(5e-3)
    step = tr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, spec),
                              spec.num_classes)
    stop = threading.Event()
    errors: List[Exception] = []

    def client_loop():
        """Per epoch: resume from the last exported global overlay, train
        locally, drop a checkpoint with the data-size metadata."""
        try:
            overlay = init_lora
            for epoch in range(epochs):
                if epoch > 0:
                    gpath = os.path.join(cfg.paths.global_model_path,
                                         f"ViT_global_epoch_{epoch - 1}.npz")
                    # wait for the service to export the previous round's global
                    ingestion.wait_for_checkpoints([gpath], policy="wait", poll_interval=0.1,
                                                   should_stop=stop.is_set)
                    if stop.is_set():
                        return
                    overlay = tree_from_numpy(ingestion.load_client_lora(gpath, spec), device)
                for cid in range(n_clients):
                    lora = tr.trainable(overlay)
                    opt_state = opt.init(lora)
                    gen = torch.Generator().manual_seed(epoch * 100 + cid)
                    x, y = shard[cid]
                    for _ in range(local_steps):
                        lora, opt_state, _ = step(base, lora, opt_state, x, y, gen)
                    ingestion.save_lora_checkpoint(
                        os.path.join(cfg.paths.local_model_path, f"client_{cid + 1}_model",
                                     f"ViT_epoch_{epoch}.npz"),
                        lora, spec, num_local_data_train=sizes[cid])
        except Exception as e:  # re-raised on the caller's thread
            errors.append(e)
            # until serve() returns: a service still starting up clears a
            # drain requested before it installed its handlers
            while not stop.wait(0.25):
                svc.request_drain()

    trainer = threading.Thread(target=client_loop, name="serve-demo-clients", daemon=True)
    trainer.start()
    try:
        records = svc.serve(cfg, max_rounds=epochs, epoch_filename="ViT_epoch_{epoch}.npz",
                            timeout=600.0, policy="fail", device=device)
    finally:
        stop.set()
        trainer.join()
    if errors:
        raise RuntimeError("the demo's client thread failed") from errors[0]

    out = cfg.output_dir
    svs = [r["shapley"] for r in records]
    if len(svs) > 1:
        plot_trajectory(svs, os.path.join(out, "sv_trajectory.png"))
    return records, out


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(prog="python -m shapley_vit_tpu_torch.examples.serve_demo")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    on_card = torch.device(args.device).type == "cuda"
    # on the card ViT-B/16 at 224 px over the full synthetic split
    cfg = demo_config("base", 224, 1.0) if on_card else demo_config()
    records, out = run_demo(cfg, epochs=args.epochs, n_clients=args.clients, device=args.device)
    for r in records:
        print(f"epoch {r['epoch']}: utility {r['utility']} "
              f"SV(acc)={ {c: round(v, 4) for c, v in r['shapley'][0].items()} }")
    print(f"artifacts in {out}")
    return records, out


if __name__ == "__main__":
    main()
