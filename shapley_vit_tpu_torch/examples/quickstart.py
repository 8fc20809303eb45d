"""Quickstart: one batched exact-Shapley round over 3 synthetic clients (the
port of ``examples/quickstart.py``).

    python -m shapley_vit_tpu_torch.examples.quickstart [--variant micro|tiny|base]
        [--val-size 64] [--batch 32] [--device cuda|cpu]

The card by default; ``--device cpu`` runs the plain versions of the kernels
(seconds on the micro model). :func:`run_quickstart` is the round itself,
from given weights, deltas and validation arrays; :func:`main` draws them
from seeded ``torch.Generator``s (the validation set from numpy's
``default_rng(0)``, as JAX's does).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from shapley_vit_tpu_torch.fl import evaluation as ev
from shapley_vit_tpu_torch.models import vit as tvit
from shapley_vit_tpu_torch.ops import tree_math as tm
from shapley_vit_tpu_torch.shapley import Game, shapley_comp_contrib, shapley_exact

SIZES = (120, 300, 580)  # the clients' data sizes drive the FedAvg ratios
NUM_CLASSES = 4


def run_quickstart(spec, base, lora0, deltas: Sequence, images: torch.Tensor,
                   labels: torch.Tensor, batch: int = 32, log=print) -> dict:
    """Exact Shapley values of the clients' ``deltas`` (LoRA overlay trees
    on the weights' device) over the validation ``images`` / ``labels``,
    then comp-contrib (m = 150) on the same memo. Returns the initial
    utility, both estimates (per utility dim, client -> value), the
    distinct evaluations after each, and the full coalition's utility."""
    n = len(labels)
    stacked = tm.tree_stack(list(deltas))
    data = [(images[i : i + batch], labels[i : i + batch]) for i in range(0, n, batch)]

    # the batched coalition evaluator: C overlays in one pass over the data
    evaluator = ev.make_coalition_evaluator(
        lambda b, lo, x: tvit.vit_forward_coalitions(b, lo, x, spec))

    def eval_coalitions(W):
        return evaluator(base, tm.materialize_coalitions(lora0, stacked, W), data,
                         dataset_size=n)

    prev = ev.evaluate_model(lambda p, x: tvit.vit_forward(p[0], p[1], x, spec),
                             (base, lora0), data)
    log(f"initial global utility: acc={prev[0]:.4f} loss={prev[1]:.4f}")
    game = Game(eval_coalitions_fn=eval_coalitions, num_local_data=list(SIZES),
                client_selection_vector=[True] * len(SIZES), previous_utility=list(prev))

    # exact Shapley: all 2^n - 1 coalitions in one batched evaluation
    sv = shapley_exact(game)
    exact_evals = game.num_evaluations
    log(f"exact SV (accuracy dim): { {c: round(v, 5) for c, v in sv[0].items()} }")
    log(f"exact SV (loss dim):     { {c: round(v, 5) for c, v in sv[1].items()} }")
    log(f"distinct coalition evaluations: {exact_evals}")

    # the live-path estimator (comp-contrib, m = 50 n) reuses the memo
    sv_cc = shapley_comp_contrib(game, m=150, rng=np.random.default_rng(0))
    log(f"comp-contrib SV (accuracy): { {c: round(v, 5) for c, v in sv_cc[0].items()} }")
    log(f"evaluations after comp-contrib (memoized): {game.num_evaluations}")
    return {"initial_utility": list(prev), "exact": sv, "exact_evaluations": exact_evals,
            "comp_contrib": sv_cc, "evaluations": game.num_evaluations,
            "grand_coalition": list(game.utility[frozenset(range(len(SIZES)))])}


def synthetic_inputs(variant: str, val_size: int, device):
    """(spec, base, lora0, three deltas, images, labels): the weights from
    generators of seed 0 and 1, each client's delta 0.05·N(0, 1) from seed
    10 + i, the validation set from ``default_rng(0)``."""
    spec = tvit.make_spec(variant, num_classes=NUM_CLASSES)
    base = tvit.init_vit(torch.Generator().manual_seed(0), spec, device=device)
    lora0 = tvit.init_lora(torch.Generator().manual_seed(1), spec, classifier_from=base,
                           device=device)
    deltas = []
    for i in range(3):
        gen = torch.Generator().manual_seed(10 + i)
        deltas.append(tm.tree_map(
            lambda leaf: (0.05 * torch.randn(leaf.shape, generator=gen)).to(device), lora0))
    rng = np.random.default_rng(0)
    images = torch.as_tensor(
        rng.normal(size=(val_size, spec.image, spec.image, 3)).astype(np.float32), device=device)
    labels = torch.as_tensor(rng.integers(0, NUM_CLASSES, size=val_size), device=device)
    return spec, base, lora0, deltas, images, labels


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(prog="python -m shapley_vit_tpu_torch.examples.quickstart")
    p.add_argument("--variant", default="micro")
    p.add_argument("--val-size", type=int, default=64)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from shapley_vit_tpu_torch.driver.start import resolve_device

    device = resolve_device(args.device)
    spec, base, lora0, deltas, images, labels = synthetic_inputs(args.variant, args.val_size,
                                                                 device)
    return run_quickstart(spec, base, lora0, deltas, images, labels, batch=args.batch)


if __name__ == "__main__":
    main()
