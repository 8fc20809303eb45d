"""Automatic (coalition, data) mesh-shape selection.

The port of ``shapley_vit_tpu/parallel/autoshape.py``: the chooser is pure
arithmetic and returns the same choice and rationale for every input; only
the byte count of a tree reads torch tensors (or numpy arrays) here.

The sharded evaluator lays a mesh over the devices with two axes:
``coalition`` (each shard evaluates a slice of the stacked coalition weight
sets) and ``data`` (each shard evaluates a slice of every validation batch).
The chooser is analytic (no trial runs: the driver picks a shape before the
first round):

  * Work.  Both mesh axes self-pad (coalition rows repeat row 0, batches
    pad zero-weighted rows), so a device's padded work for coalition-axis
    size k over D devices is ``W(k) = ceil(C/k) * ceil(B*k/D)``, the
    examples x coalitions it actually computes. Minimizing W minimizes the
    round's critical path: the mesh is bulk-synchronous (the metric sums
    join all shards), so the slowest shard is the round time.
  * Matrix-unit feed.  Among W-minimal shapes, prefer the LARGEST
    per-device batch (fewest, biggest products). At C=8/D=8/B=128 all
    splits do equal padded work, but 1 coalition x 128 examples a device
    runs one (128·T) x D x D product chain where pure data-parallel runs
    eight 16-example ones: the same FLOPs, better occupancy and fewer
    launches.
  * Memory.  Each device holds ``ceil(C/k)`` coalition weight sets
    (coalition sharding divides the stacked-tree residency that pure
    data-parallel replicates). When ``coalition_bytes``/``hbm_bytes`` are
    given, shapes whose residency exceeds the budget are discarded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ShardChoice:
    """One candidate coalition-axis size with its predicted cost terms."""

    n_coalition: int
    n_data: int
    padded_work: int          # per-device examples x coalitions (incl. padding)
    batch_per_device: int     # examples each device sees per batch
    coalitions_per_device: int
    resident_bytes: int       # stacked coalition weights resident per device
    rationale: str = ""


def enumerate_shard_choices(
    n_devices: int,
    coalitions: int,
    batch: int,
    coalition_bytes: int = 0,
) -> List[ShardChoice]:
    """All divisor splits of the device count with their cost terms."""
    out = []
    for k in range(1, n_devices + 1):
        if n_devices % k:
            continue
        d = n_devices // k
        cpd = -(-coalitions // k) if coalitions else 1
        bpd = -(-batch // d) if batch else 1
        out.append(
            ShardChoice(
                n_coalition=k,
                n_data=d,
                padded_work=cpd * bpd,
                batch_per_device=bpd,
                coalitions_per_device=cpd,
                resident_bytes=cpd * coalition_bytes,
            )
        )
    return out


def choose_coalition_shards(
    n_devices: int,
    coalitions: int,
    batch: int,
    coalition_bytes: int = 0,
    hbm_bytes: int = 0,
    model_bytes: int = 0,
) -> ShardChoice:
    """Pick the (coalition, data) split for the driver mesh.

    ``coalitions`` is the dominant per-call coalition count (the evaluator
    chunk, or the full powerset when unchunked); ``batch`` the eval batch
    size. ``coalition_bytes`` (one stacked coalition's weight residency,
    e.g. the 28MB/coalition merged fold for ViT-B) + ``hbm_bytes`` /
    ``model_bytes`` enable the memory filter; zero disables it.

    Order: feasible by memory -> minimal padded work -> largest per-device
    batch -> smallest coalition axis (stability tie-break). Always returns
    a choice — if nothing fits the memory budget the most-sharded feasible
    work-minimal shape is returned with a warning rationale (the evaluator
    still runs; chunking bounds true residency).
    """
    cands = enumerate_shard_choices(n_devices, coalitions, batch, coalition_bytes)
    # None == filter disabled (no hbm figure); a budget of exactly 0 — or
    # negative, when the model estimate alone exceeds device memory — must
    # still FILTER (nothing fits) rather than silently pass every shape
    budget = (hbm_bytes - model_bytes) if hbm_bytes else None
    feasible = [
        c for c in cands if budget is None or c.resident_bytes <= budget
    ]
    pool = feasible or cands
    best = min(
        pool,
        key=lambda c: (c.padded_work, -c.batch_per_device, c.n_coalition),
    )
    why = (
        f"C={coalitions} B={batch} D={n_devices}: "
        f"mesh {best.n_coalition}x{best.n_data} — padded work "
        f"{best.padded_work} examples·coalitions/device "
        f"({best.coalitions_per_device} coalitions x "
        f"{best.batch_per_device}/batch)"
    )
    if budget is not None and not feasible:
        if budget <= 0:
            why += (
                f" [WARNING: model residency {model_bytes / 1e9:.2f}GB "
                f">= device memory {hbm_bytes / 1e9:.2f}GB — no coalition "
                "budget at any split; relying on the evaluator's chunking]"
            )
        else:
            why += (
                f" [WARNING: {best.resident_bytes / 1e9:.2f}GB coalition "
                f"residency exceeds the {budget / 1e9:.2f}GB budget at every "
                "split; relying on the evaluator's chunking]"
            )
    elif budget is not None:
        why += f", residency {best.resident_bytes / 1e6:.0f}MB within budget"
    best.rationale = why
    return best


def powerset_dominant_coalitions(num_clients: int, chunk: int) -> int:
    """The dominant per-evaluator-call coalition count for the drivers: the
    full powerset when it fits one call, else the chunk size (estimators
    submit chunk-aligned blocks — driver/serve.py prewarm logic)."""
    full = 2**num_clients - 1
    return min(full, chunk) if chunk else full


def coalition_residency_bytes(
    varying_example, eval_mode: str = "overlay", spec=None
) -> Optional[int]:
    """Per-coalition device residency for the memory filter.

    ``varying_example``: one coalition's varying tree (the LoRA overlay, or
    whatever feeds forward_fn). None disables the filter. In
    ``eval_mode="merged"`` pass the model ``ViTSpec`` too: merged eval folds
    per-coalition DENSE q/v kernels on top of the overlay
    (2·depth·hidden² compute-dtype bytes — 28MB for ViT-B bf16), and that
    term is accounted here so every caller sizes the fold identically."""
    if varying_example is None:
        return None
    from shapley_vit_tpu_torch.ops.tree_math import tree_nbytes

    total = tree_nbytes(varying_example)
    if eval_mode == "merged":
        if spec is None:
            raise ValueError(
                "eval_mode='merged' needs spec= to size the folded "
                "dense q/v kernels"
            )
        itemsize = spec.compute_dtype.itemsize
        total += 2 * spec.depth * spec.hidden * spec.hidden * itemsize
    return total
