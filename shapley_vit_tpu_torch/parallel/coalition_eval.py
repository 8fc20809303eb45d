"""Mesh-sharded coalition evaluation.

The port of ``shapley_vit_tpu/parallel/coalition_eval.py``. The
single-device primitive (``fl.evaluation.make_coalition_evaluator``) runs
the coalition axis in one forward; this module lays it over a mesh: the
coalition axis split over the mesh's ``coalition`` axis, each batch over
its ``data`` axis, the base replicated once per distinct device. One host
thread queues every cell's forward before it reads any result back, so the
devices run side by side; each cell keeps its per-coalition (correct, loss)
sums on its device, and they come to the host once per coalition chunk,
where the data-axis partial sums are added (the JAX package's ``psum``). In
a multi-process world each rank evaluates its own cells, and an
``all_reduce`` of the zero-filled grid of partial sums gives every rank all
of them.

Shapes are handled here: the evaluator pads the coalition axis up to a
multiple of the mesh's coalition-axis size (repeating row 0 and dropping
the padded rows) and pads remainder validation batches up to a multiple of
the data-axis size with zero-WEIGHTED rows, so callers never align shapes.

:func:`make_eval_backend` is the drivers' gate: with ``dist.mesh="auto"``
they shard whenever more than one device is given, as the reference's
always-on ``nn.DataParallel`` (start.py:283) does; on one device the mesh
is 1x1.

The JAX evaluator's ``pad_buckets`` and ``shape_hints`` bound XLA's compile
count; eager PyTorch compiles nothing, so they are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map
from shapley_vit_tpu_torch.parallel import distributed as pdist
from shapley_vit_tpu_torch.parallel.mesh import (
    COALITION_AXIS,
    DATA_AXIS,
    Mesh,
    as_tensor,
    device_put,
    make_mesh,
    put_coalition_stacked,
    put_replicated,
    shard_batch,
)
from shapley_vit_tpu_torch.utils.profiling import span

Tree = Any


def masked_eval_step_metrics(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fl.evaluation.eval_step_metrics`` with a per-example weight (1.0
    real, 0.0 padding): [C, B, K] logits -> [C] weighted correct counts and
    summed cross-entropy, float32. With all-ones weights the sums equal the
    unweighted step's (``1.0 * x == x``)."""
    logits = logits.float()
    labels = labels.long()
    correct = (weights * (logits.argmax(dim=-1) == labels)).sum(dim=-1)
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.expand(logp.shape[:-1]).unsqueeze(-1)
    nll = -torch.gather(logp, -1, idx).squeeze(-1)
    return correct, (weights * nll).sum(dim=-1)


class ShardedBatch(tuple):
    """One validation batch laid out on a mesh: ``(images, labels,
    weights)``, each a dict from this process's cells to the cell's slice
    of the data axis on its device (weights 0.0 on padding rows). ``rows``
    is the batch's size over the whole data axis, padding included."""

    rows: int


def _prep_batch(mesh: Mesh, images, labels, weights=None) -> ShardedBatch:
    """Pad a batch up to a multiple of the data-axis size (zero-weighted
    repeats of row 0) and place it split over ``data``."""
    n_d = mesh.shape[DATA_AXIS]
    images, labels = as_tensor(images), as_tensor(labels).long()
    B = int(labels.shape[0])
    weights = (torch.ones(B, dtype=torch.float32) if weights is None
               else as_tensor(weights).float())
    pad = (-B) % n_d
    if pad:
        images = torch.cat([images] + [images[:1]] * pad)
        labels = torch.cat([labels] + [labels[:1]] * pad)
        weights = torch.cat([weights, weights.new_zeros(pad)])
    s = shard_batch(mesh)
    out = ShardedBatch((device_put(images, s), device_put(labels, s), device_put(weights, s)))
    out.rows = B + pad
    return out


class ShardedBatches(list):
    """List of :class:`ShardedBatch` that also carries the host-known
    real-example count (``real_examples``). The evaluator reads the count
    from here instead of summing weights that, in a multi-process world,
    live partly on other ranks."""

    # annotation only, no class-level default: a hand-built instance that
    # never set the count reads as "count unknown" (the evaluator counts),
    # not as 0.0 examples
    real_examples: float


def shard_batches(mesh: Mesh, batches) -> ShardedBatches:
    """Lay a validation stream out ONCE for a mesh: a list of
    :class:`ShardedBatch`. Drivers call this at bring-up and reuse the
    result every round. ``real_examples`` records the unpadded (weighted)
    example count, taken on the host before placement."""
    out = ShardedBatches()
    total = 0.0
    for b in (batches() if callable(batches) else batches):
        if len(b) == 3 and b[2] is not None:
            total += float(np.asarray(b[2], np.float32).sum())
        else:
            total += float(len(b[1]))
        out.append(_prep_batch(mesh, *b))
    out.real_examples = total
    return out


def make_sharded_coalition_evaluator(
    forward_fn: Callable[[Tree, Tree, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    coalition_chunk: int = 0,
):
    """Build a mesh-sharded batched evaluator.

    ``forward_fn(shared, stacked_varying, images) -> logits [C, B, K]`` as
    in the single-device evaluator. Returns ``evaluate(shared,
    stacked_varying, batches, dataset_size=None) -> np.ndarray [C, 2]`` of
    (accuracy, mean_loss) rows.

    Any coalition count C and any batch size work (see the module
    docstring). ``coalition_chunk`` bounds how many coalitions are resident
    at once; a chunk that is not a multiple of the coalition axis is
    rounded down to one (floor: one coalition per shard).

    ``batches`` may yield (images, labels) pairs or (images, labels,
    weights) triples (placed and padded per call), or the
    :class:`ShardedBatch` items of :func:`shard_batches` (reused as they
    are: the fast path for a service that evaluates the same validation
    stream every round). A NaN loss raises ``FloatingPointError``.
    """
    n_c = mesh.shape[COALITION_AXIS]
    n_d = mesh.shape[DATA_AXIS]
    cells = mesh.local_cells()
    if coalition_chunk:
        # a chunk that is not an axis multiple would be padded up past the
        # memory-derived cap inside run_chunk: round it down instead
        coalition_chunk = max(n_c, (coalition_chunk // n_c) * n_c)

    # one-slot identity cache for the replicated shared tree: the drivers
    # pass the SAME frozen base every round, and copying it to every device
    # on each evaluate() call would cost several full-model transfers per
    # round. The strong reference to the key makes id reuse impossible.
    _rep: Dict[str, Any] = {"obj": None, "rep": None}

    def _replicated(shared: Tree) -> Dict:
        if _rep["obj"] is shared:
            return _rep["rep"]
        with span("eval.replicate"):
            rep = put_replicated(mesh, shared)
        _rep["obj"], _rep["rep"] = shared, rep
        return rep

    def run_chunk(shared_d, params_chunk, prepped) -> Tuple[np.ndarray, np.ndarray]:
        cc = tree_leaves(params_chunk)[0].shape[0]
        target = -(-cc // n_c) * n_c  # round up to the axis multiple
        with span("eval.place"):
            if target != cc:
                params_chunk = tree_map(
                    lambda leaf: torch.cat([leaf] + [leaf[:1]] * (target - cc)), params_chunk
                )
            params_d = put_coalition_stacked(mesh, params_chunk)
        sums: Dict = {}
        with torch.inference_mode():
            # batches outer, cells inner: every device has work queued
            # before the host waits on any of them
            with span("eval.enqueue"):
                for images, labels, weights in prepped:
                    for cell in cells:
                        c, l = masked_eval_step_metrics(
                            forward_fn(shared_d[cell], params_d[cell], images[cell]),
                            labels[cell], weights[cell],
                        )
                        if cell in sums:
                            c, l = sums[cell][0] + c, sums[cell][1] + l
                        sums[cell] = (c, l)
            # [metric, coalition shard, data shard, row]: this rank's
            # cells filled, the others' zero
            grid = np.zeros((2, n_c, n_d, target // n_c), np.float32)
            with span("eval.readback"):
                for (ci, di), (c, l) in sums.items():
                    grid[0, ci, di] = c.cpu().numpy()
                    grid[1, ci, di] = l.cpu().numpy()
        if tdist.is_initialized() and mesh.world == pdist.world_size():
            # each cell belongs to one rank, so the sum of the zero-filled
            # grids is every cell's sums, exactly (on one rank: identity)
            with span("eval.all_reduce"):
                grid = pdist.all_reduce_host(grid, "sum")
        total = grid.sum(axis=2, dtype=np.float32).reshape(2, target)
        return total[0, :cc], total[1, :cc]

    def evaluate(
        shared: Tree,
        stacked_varying: Tree,
        batches,
        dataset_size: Optional[int] = None,
    ) -> np.ndarray:
        with span("eval"):
            return _evaluate(shared, stacked_varying, batches, dataset_size)

    def _evaluate(shared, stacked_varying, batches, dataset_size):
        shared_d = _replicated(shared)
        C = tree_leaves(stacked_varying)[0].shape[0]
        if callable(batches):
            batches = batches()
        if not isinstance(batches, (list, tuple)):
            batches = list(batches)  # every chunk must see the whole stream
        # the example count is host-known at placement (pairs and host
        # triples here; shard_batches records it): never read back per chunk
        prepped = []
        seen = getattr(batches, "real_examples", None)
        if seen is None:
            seen = 0.0
            for b in batches:
                if isinstance(b, ShardedBatch):
                    prepped.append(b)
                    if dataset_size is not None:
                        continue
                    if mesh.world > 1:
                        # other ranks hold part of the weights: fail with the
                        # contract, not deep in a read of a missing cell
                        raise ValueError(
                            "multi-process evaluate() with pre-sharded "
                            "batches needs dataset_size= (or use "
                            "shard_batches, which records the count)"
                        )
                    seen += sum(float(b[2][(0, d)].sum()) for d in range(n_d))
                else:
                    if dataset_size is None:
                        w = b[2] if len(b) == 3 else None
                        seen += (float(np.asarray(w, np.float32).sum()) if w is not None
                                 else float(len(b[1])))
                    prepped.append(_prep_batch(mesh, *b))
        else:
            prepped = list(batches)

        if coalition_chunk and C > coalition_chunk:
            outs = [
                run_chunk(
                    shared_d,
                    tree_map(lambda leaf: leaf[s : s + coalition_chunk], stacked_varying),
                    prepped,
                )
                for s in range(0, C, coalition_chunk)
            ]
            correct = np.concatenate([o[0] for o in outs])
            loss = np.concatenate([o[1] for o in outs])
        else:
            correct, loss = run_chunk(shared_d, stacked_varying, prepped)

        n = dataset_size if dataset_size is not None else seen
        acc = correct / np.float32(n)
        mean_loss = loss / np.float32(n)
        if np.isnan(mean_loss).any():
            bad = np.nonzero(np.isnan(mean_loss))[0].tolist()
            raise FloatingPointError(f"NaN validation loss for coalitions {bad}")
        return np.stack([acc, mean_loss], axis=1)

    return evaluate


class EvalBackend:
    """The drivers' evaluation surface: the coalition evaluator sharded over
    ``mesh``, the matching upload of a validation set, and single-model
    evaluation through the same path, so the drivers run the same code on
    one card and on many.

    ``mesh`` None is a 1x1 mesh of ``device``: the same sums as the
    single-device evaluator (weights of 1.0, one data shard), bit for bit.
    ``stack_single`` maps one model's overlay to a C=1 stacked varying tree
    for ``forward_fn`` (merged mode folds the overlay into q/v kernels, so
    the overlay cannot be fed directly); None stacks the overlay itself.
    """

    def __init__(self, forward_fn, coalition_chunk: int = 0, device="cuda",
                 stack_single: Optional[Callable[[Tree], Tree]] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh(devices=[device])
        self.evaluate = make_sharded_coalition_evaluator(
            forward_fn, self.mesh, coalition_chunk=coalition_chunk
        )
        self._stack_single = stack_single or (lambda overlay: tree_map(lambda a: a[None], overlay))

    def device_batches(self, ds, batch_size: int) -> ShardedBatches:
        """Upload the validation set once, laid out for this backend:
        data-axis-split (and remainder-padded) :class:`ShardedBatch` items
        of at most ``batch_size`` examples."""
        images = np.asarray(ds.images, np.float32)
        labels = np.asarray(ds.labels).astype(np.int64)
        return shard_batches(
            self.mesh,
            [(images[i : i + batch_size], labels[i : i + batch_size])
             for i in range(0, len(ds), batch_size)],
        )

    def evaluate_single(self, shared: Tree, varying: Tree, batches,
                        dataset_size: Optional[int] = None) -> Tuple[float, float]:
        """Single-model (accuracy, mean_loss) as a C=1 coalition stack (the
        batch still splits over ``data``)."""
        row = self.evaluate(shared, self._stack_single(varying), batches,
                            dataset_size=dataset_size)[0]
        return float(row[0]), float(row[1])


def make_eval_backend(
    forward_fn: Callable[[Tree, Tree, torch.Tensor], torch.Tensor],
    coalition_chunk: int = 0,
    dist_cfg=None,
    devices=None,
    log_fn: Optional[Callable[[str], None]] = None,
    stack_single: Optional[Callable[[Tree], Tree]] = None,
    typical_coalitions: int = 0,
    eval_batch: int = 0,
    coalition_bytes: int = 0,
    model_bytes: int = 0,
    device="cuda",
) -> EvalBackend:
    """Device-count-gated backend factory for the drivers.

    ``devices`` are this process's devices to shard over (default:
    ``parallel.distributed.default_local_devices(device)``); in a
    ``torch.distributed`` world the mesh spans every rank's. A device may
    repeat. With ``dist_cfg.mesh`` ``"auto"`` (the default) more than one
    device in all gives a ``(coalition, data)`` mesh over ALL of them; one
    device, or ``"off"``, gives a 1x1 mesh of ``device``, bit-identical to
    the single-device evaluator.

    ``dist_cfg.mesh_coalition_shards`` >= 1 forces the coalition-axis size;
    0 picks it from the workload hints (``typical_coalitions``, the dominant
    per-call coalition count, and ``eval_batch``; ``parallel.autoshape``,
    memory-filtered by the card's memory from ``torch.cuda.mem_get_info``),
    or pure data-parallel without hints."""
    mode = getattr(dist_cfg, "mesh", "auto") if dist_cfg is not None else "auto"
    if mode not in ("auto", "off"):
        raise ValueError(f"dist.mesh must be 'auto' or 'off', got {mode!r}")
    mesh = None
    if mode != "off":
        local = [torch.device(d) for d in (devices if devices is not None
                                           else pdist.default_local_devices(device))]
        n_dev = len(pdist.global_devices(local)[0])
        if n_dev > 1:
            n_c = getattr(dist_cfg, "mesh_coalition_shards", 0) if dist_cfg else 0
            why = f"mesh_coalition_shards={n_c} (operator override)" if n_c else ""
            if not n_c:
                if typical_coalitions and eval_batch:
                    from shapley_vit_tpu_torch.parallel.autoshape import choose_coalition_shards

                    hbm = (torch.cuda.mem_get_info(local[0])[1] if local[0].type == "cuda"
                           else 0)
                    choice = choose_coalition_shards(
                        n_dev, typical_coalitions, eval_batch,
                        coalition_bytes=coalition_bytes, hbm_bytes=hbm,
                        model_bytes=model_bytes,
                    )
                    n_c, why = choice.n_coalition, choice.rationale
                else:
                    n_c, why = 1, "pure data-parallel (no workload hints)"
            if n_dev % n_c:
                raise ValueError(
                    f"mesh_coalition_shards={n_c} does not divide {n_dev} devices"
                )
            mesh = pdist.make_global_mesh(dist_cfg, n_coalition=n_c, local=local)
            if log_fn is not None:
                log_fn(
                    f"coalition eval sharded over {n_dev} devices "
                    f"(mesh {n_c}x{n_dev // n_c} [{COALITION_AXIS},{DATA_AXIS}]): " + why
                )
    return EvalBackend(forward_fn, coalition_chunk=coalition_chunk, device=device,
                       stack_single=stack_single, mesh=mesh)
