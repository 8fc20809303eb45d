"""Multi-round FL orchestration with per-round Shapley valuation.

The port of ``shapley_vit_tpu/driver/rounds.py`` and, as :func:`main`
(``python -m shapley_vit_tpu_torch.driver.rounds``), of
``examples/multi_round_fl.py``. The reference's live path runs ONE Shapley
round against externally-trained checkpoints (start.py); its multi-round
machinery (per-round deltas + selection matrix + lazy reconstruction,
utils_fed_shapley.py; round selection under budget, milp.py; round-wise
estimators, compared_methods.py) is present but never wired to a driver.
This module wires the full stack in-process:

  round loop:  clients train locally (LoRA through the kernels that have a
               gradient) → server FedAvg → new global overlay → per-round
               client deltas recorded
  valuation:   MILP selects which rounds get Shapley under a budget; each
               selected round runs the configured estimator over a Game
               backed by ONE batched coalition evaluation; the lazy
               multi-round utilities come from the stacked round×client
               delta axis (shapley/fed_shapley.py).

What changed in the port:

* Overlays are trees of tensors. A client's delta and the FedAvg step are
  taken under ``torch.no_grad()``, so no round keeps the trained overlay's
  leaves or an autograd graph alive; every evaluation (``evaluate_fn`` and
  the coalition evaluator) runs under ``torch.inference_mode()``.
* GTG precomputes each convergence round's prefix coalitions in one
  evaluator call (``batch_prefixes=True``); the JAX driver streams one
  coalition a call. The rng stream, and so the Shapley values, are the same.
* ``timer`` (a ``utils.profiling.StepTimer``) records the spans ``train``
  (one client's local training), ``evaluate`` (the global model),
  ``milp``, ``shapley`` (one round's estimator) and ``coalition_eval`` (each
  evaluator call inside it), so a round's host time can be told apart from
  its evaluation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.shapley import (
    Game,
    MILP_Shapley,
    call_shapley_computation_method,
    shapley_exact,
)
from shapley_vit_tpu_torch.shapley.compared_methods import GTG, MR, TMR
from shapley_vit_tpu_torch.utils.logging import get_logger
from shapley_vit_tpu_torch.utils.profiling import StepTimer

PyTree = object


@dataclasses.dataclass
class RoundRecord:
    """Per-round artifacts: deltas (vs. that round's starting overlay),
    participation, utilities."""

    deltas: List[Optional[PyTree]]
    selection: List[bool]
    global_overlay: PyTree
    utility: List[float]             # [acc, loss] of the post-agg global
    shapley: Optional[List[Dict[int, float]]] = None


def round_game(
    records: Sequence[RoundRecord],
    t: int,
    init_overlay: PyTree,
    evaluate_fn: Callable,
    eval_coalitions_fn_factory: Callable,
    num_local_data: Sequence[float],
    utility_dim: int = 2,
    timer: Optional[StepTimer] = None,
) -> Game:
    """The Game of round ``t``: coalitions of that round's participants,
    materialized from the round's starting overlay and its stacked client
    deltas (a non-participant's delta stacked as zeros), scored against the
    starting overlay's utility."""
    timer = timer or StepTimer()
    rec = records[t]
    start_overlay = init_overlay if t == 0 else records[t - 1].global_overlay
    if t == 0:
        with timer.span("evaluate"), torch.inference_mode():
            prev_utility = list(evaluate_fn(start_overlay))
    else:
        prev_utility = records[t - 1].utility
    stacked = tm.tree_stack([
        d if d is not None else tm.tree_zeros_like(init_overlay) for d in rec.deltas
    ])
    evaluate = eval_coalitions_fn_factory(start_overlay, stacked)

    def eval_fn(W):
        with timer.span("coalition_eval"), torch.inference_mode():
            return evaluate(W)

    return Game(
        eval_coalitions_fn=eval_fn,
        num_local_data=num_local_data,
        client_selection_vector=rec.selection,
        previous_utility=prev_utility,
        utility_dim=utility_dim,
        n_all=len(rec.deltas),
    )


def run_federated_rounds(
    *,
    num_rounds: int,
    clients_data: Sequence,                       # per-client (images, labels) tuples
    init_overlay: PyTree,
    train_client_fn: Callable,                    # (cid, overlay, data, round) -> new overlay
    evaluate_fn: Callable,                        # (overlay) -> [acc, loss]
    eval_coalitions_fn_factory: Callable,         # (init_overlay, stacked_deltas) -> W -> [C,2]
    num_local_data: Sequence[float],
    participation: Optional[np.ndarray] = None,   # [T, n] bool; default all
    estimator: str = "comp_contrib",
    shapley_budget: Optional[int] = None,         # k_max rounds get Shapley (MILP)
    utility_dim: int = 2,
    seed: int = 0,
    cc_stratify: str = "uniform",
    logger=None,
    timer: Optional[StepTimer] = None,
) -> List[RoundRecord]:
    """Run T federated rounds; Shapley-value the selected ones.

    ``estimator``: comp_contrib (live-path default) | exact | gtg | mr | tmr.
    ``cc_stratify``: comp-contrib split-point allocation
    (``cfg.shapley.cc_stratify``; see shapley/estimators.py). Round ``t``'s
    comp-contrib draws from seed ``seed + 1000 + t``, its GTG from
    ``seed + 2000 + t``.
    """
    if estimator not in ("comp_contrib", "exact", "gtg", "mr", "tmr"):
        raise ValueError(f"unknown estimator {estimator!r}")
    logger = logger or get_logger()
    timer = timer or StepTimer()
    n = len(clients_data)
    if participation is None:
        participation = np.ones((num_rounds, n), dtype=bool)

    records: List[RoundRecord] = []
    overlay = init_overlay

    # ---- FL rounds -------------------------------------------------------
    for t in range(num_rounds):
        deltas: List[Optional[PyTree]] = []
        for cid in range(n):
            if not participation[t][cid]:
                deltas.append(None)
                continue
            with timer.span("train"):
                new_overlay = train_client_fn(cid, overlay, clients_data[cid], t)
            with torch.no_grad():
                deltas.append(tm.tree_sub(new_overlay, overlay))
        members = [i for i in range(n) if deltas[i] is not None]
        ratio = tm.fedavg_ratio([num_local_data[i] for i in members])
        with torch.no_grad():
            agg = tm.aggregate_deltas(tm.tree_stack([deltas[i] for i in members]), ratio)
            overlay = tm.apply_deltas(overlay, agg)
        with timer.span("evaluate"), torch.inference_mode():
            utility = list(evaluate_fn(overlay))
        logger.info(f"round {t}: participants={members} utility={utility}")
        records.append(
            RoundRecord(
                deltas=deltas,
                selection=[deltas[i] is not None for i in range(n)],
                global_overlay=overlay,
                utility=utility,
            )
        )

    # ---- which rounds get Shapley (MILP under budget) --------------------
    sel_matrix = np.array([r.selection for r in records], dtype=float)
    with timer.span("milp"):
        if shapley_budget is not None and shapley_budget < num_rounds:
            ok, _, x = MILP_Shapley(sel_matrix, max_shapley_computation=shapley_budget).solve()
            chosen = np.nonzero(np.round(x).astype(int))[0] if ok else np.arange(num_rounds)
        else:
            chosen = np.arange(num_rounds)
    logger.info(f"Shapley rounds selected: {chosen.tolist()}")

    # ---- per-round valuation --------------------------------------------
    for t in chosen:
        game = round_game(records, t, init_overlay, evaluate_fn, eval_coalitions_fn_factory,
                          num_local_data, utility_dim=utility_dim, timer=timer)
        with timer.span("shapley"):
            if estimator == "comp_contrib":
                sv = call_shapley_computation_method(
                    {},
                    game,
                    logger,
                    rng=np.random.default_rng(seed + 1000 + t),
                    stratify=cc_stratify,
                )
            elif estimator == "exact":
                sv = shapley_exact(game)
            else:
                sv = []
                for dim in range(utility_dim):
                    if estimator == "gtg":
                        est = GTG(dim, rng=np.random.default_rng(seed + 2000 + t),
                                  batch_prefixes=True)
                    else:
                        est = {"mr": MR, "tmr": TMR}[estimator](dim)
                    sv.append(est.compute_shapley_value(game, t))
        records[t].shapley = sv
        logger.info(f"round {t} Shapley: {sv}")

    return records


# ---------------------------------------------------------------------------
# the model behind the loop, and the CLI (examples/multi_round_fl.py)
# ---------------------------------------------------------------------------

def build_round_fns(cfg, device="cuda", local_steps: int = 3) -> dict:
    """ViT + LoRA from ``cfg`` (``driver.start.build_model``) and the three
    callables :func:`run_federated_rounds` takes:

    * ``train_client_fn``: ``local_steps`` Adam 5e-3 steps (``fl/training``,
      under ``driver.client.TRAIN_SPEC``) from the round's global overlay,
      each on ``cfg.train.train_batch * 8`` examples (64 by default, the
      client driver's batch) of the client's (images, labels) tensors drawn
      without replacement (all of them when the client has no more), from
      a generator seeded with ``cfg.shapley.seed``, the round and the client;
    * ``evaluate_fn`` and ``eval_coalitions_fn_factory``: the driver's
      evaluator (``driver.start.build_eval_backend``, ``cfg.model.eval_mode``)
      on the validation set, uploaded once.

    Returns a dict with those three, ``spec``, ``base``, ``init_lora``,
    ``valid`` (the validation set), ``data`` (its device batches) and
    ``train`` (the training split at its own image size, for the clients'
    shards)."""
    from shapley_vit_tpu_torch.driver import start as start_mod
    from shapley_vit_tpu_torch.driver.client import TRAIN_SPEC
    from shapley_vit_tpu_torch.fl import training as tr
    from shapley_vit_tpu_torch.models import vit as tvit

    device = start_mod.resolve_device(device)
    spec, base, init_lora = start_mod.build_model(cfg, device=device)
    train_spec = spec.replace(**TRAIN_SPEC)
    splits = start_mod.load_oct_splits(cfg)
    valid = start_mod.load_validation_dataset(cfg, target_size=spec.image, device=device,
                                              splits=splits)
    backend, eval_coalitions, _ = start_mod.build_eval_backend(cfg, spec, base, init_lora,
                                                               device=device)
    data = backend.device_batches(valid, cfg.data.eval_batch_size)
    opt = tr.adam(5e-3)
    batch = cfg.train.train_batch * 8
    step = tr.make_train_step(lambda b, lo, x: tvit.vit_forward(b, lo, x, train_spec),
                              spec.num_classes)

    def train_client_fn(cid, overlay, client_data, rnd):
        images, labels = client_data
        lora = tr.trainable(overlay)
        state = opt.init(lora)
        rng = np.random.default_rng([cfg.shapley.seed, rnd, cid])
        n_local = len(labels)
        for _ in range(local_steps):
            if n_local <= batch:
                x, y = images, labels
            else:
                take = torch.as_tensor(rng.choice(n_local, size=batch, replace=False),
                                       device=images.device)
                x, y = images[take], labels[take]
            lora, state, loss = step(base, lora, state, x, y)
        float(loss)  # wait for the card: the caller's span covers the training
        return lora

    def evaluate_fn(overlay):
        return backend.evaluate_single(base, overlay, data, dataset_size=len(valid))

    def eval_coalitions_fn_factory(start_overlay, stacked):
        return lambda W: eval_coalitions(start_overlay, stacked, W, data, dataset_size=len(valid))

    return dict(spec=spec, base=base, init_lora=init_lora, valid=valid, data=data,
                train=splits["train"], train_client_fn=train_client_fn, evaluate_fn=evaluate_fn,
                eval_coalitions_fn_factory=eval_coalitions_fn_factory)


def client_tensors(images: np.ndarray, labels: np.ndarray, image_size: int, device):
    """A client's (images, labels) on ``device``, the images resized once to
    the model's input size."""
    from shapley_vit_tpu_torch.driver import start as start_mod

    if images.shape[1] != image_size:
        images = start_mod.resize_images(images.astype(np.float32), image_size, device=device)
    return (torch.as_tensor(np.asarray(images, np.float32), device=device),
            torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device))


def main(argv: Optional[List[str]] = None) -> int:
    """Multi-round FL with per-round Shapley valuation, end to end
    in-process: three clients with non-IID Dirichlet shards of the synthetic
    OCT layout train LoRA locally for several rounds (3 Adam 5e-3 steps on
    their first 64 examples, FedAvg-weighted by their shard sizes); a MILP
    budget picks which rounds get Shapley; per-round scores go to
    ``<out>/shapley_rounds.csv``, with a trajectory plot where matplotlib
    imports.

    ``--device cuda`` (the default) runs ViT-B/16 at 224 px in bf16 on the
    card; ``--device cpu`` runs the micro ViT at 16 px in float32."""
    p = argparse.ArgumentParser(prog="python -m shapley_vit_tpu_torch.driver.rounds")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--budget", type=int, default=2)
    p.add_argument("--estimator", default="exact",
                   choices=["exact", "comp_contrib", "gtg", "mr", "tmr"])
    p.add_argument("--out", default="exp/multi_round_demo")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from shapley_vit_tpu_torch.config import Config
    from shapley_vit_tpu_torch.data.partition import partition_labeldir
    from shapley_vit_tpu_torch.driver import start as start_mod
    from shapley_vit_tpu_torch.driver.report import plot_shapley_rounds, write_shapley_csv

    device = start_mod.resolve_device(args.device)
    cfg = Config()
    cfg.paths.validation_dataset = ""  # the synthetic OCT layout
    if device.type == "cpu":
        cfg.model.vit_variant, cfg.model.compute_dtype = "micro", "float32"
        cfg.data.synthetic_scale = 0.02
    n = 3
    fns = build_round_fns(cfg, device=device)
    train, image = fns["train"], fns["spec"].image
    _, mapping = partition_labeldir(train.labels, num_classes=fns["spec"].num_classes,
                                    n_parties=n, beta=0.5)
    clients_data = [client_tensors(train.images[mapping[c]][:64], train.labels[mapping[c]][:64],
                                   image, device) for c in range(n)]
    sizes = [len(mapping[c]) for c in range(n)]

    records = run_federated_rounds(
        num_rounds=args.rounds,
        clients_data=clients_data,
        init_overlay=fns["init_lora"],
        train_client_fn=fns["train_client_fn"],
        evaluate_fn=fns["evaluate_fn"],
        eval_coalitions_fn_factory=fns["eval_coalitions_fn_factory"],
        num_local_data=sizes,
        estimator=args.estimator,
        shapley_budget=args.budget,
    )

    os.makedirs(args.out, exist_ok=True)
    valued = [(t, r.shapley) for t, r in enumerate(records) if r.shapley is not None]
    for t, sv in valued:
        write_shapley_csv(os.path.join(args.out, "shapley_rounds.csv"), sv, round_idx=t)
        print(f"round {t}: global utility {records[t].utility}, "
              f"SV(acc)={ {c: round(v, 4) for c, v in sv[0].items()} }")
    if len(valued) > 1:
        try:
            plot_shapley_rounds([sv for _, sv in valued],
                                os.path.join(args.out, "sv_trajectory.png"))
        except ImportError:
            print("matplotlib is not installed: no trajectory plot")
    print(f"artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
