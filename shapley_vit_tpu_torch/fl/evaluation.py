"""Validation-set evaluation: the hot path.

The port of ``shapley_vit_tpu/fl/evaluation.py`` (reference
``evaluation(args, net, eval_loader)``, federated_learning/utils.py:864-926):
per batch, logits -> argmax-correct count + summed cross-entropy, both
normalized by the dataset size at the end.

* Gradients are never recorded (``torch.inference_mode``).
* The correct/loss accumulators stay on the device across batches; one host
  transfer per evaluation.
* The coalition evaluator runs C coalition models in one pass: the forward
  takes a stacked per-coalition tree and returns ``[C, B, K]`` logits (the
  coalition axis written out, where the JAX package ``vmap``s).

The JAX evaluator's ``pad_buckets`` and ``shape_hints`` are not ported: they
bound how many XLA programs get compiled for varying coalition counts, and
eager PyTorch compiles nothing. Padded rows were dropped there, so results
are the same. ``coalition_chunk`` (it bounds memory) and the NaN guard
(utils.py:918-922) are kept.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map

Tree = Any


def eval_step_metrics(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch (correct_count, ce_loss_sum) as float32 tensors on the
    logits' device; a leading coalition axis ``[C, B, K]`` gives ``[C]``
    results. CE matches torch ``CrossEntropyLoss(reduction='sum')``
    (utils.py:873), in float32; argmax takes the first maximum on ties."""
    logits = logits.float()
    labels = labels.long()
    correct = (logits.argmax(dim=-1) == labels).sum(dim=-1).float()
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.expand(logp.shape[:-1]).unsqueeze(-1)
    nll = -torch.gather(logp, -1, idx).squeeze(-1)
    return correct, nll.sum(dim=-1)


def evaluate_model(
    forward_fn: Callable[[Tree, torch.Tensor], torch.Tensor],
    params: Tree,
    batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    dataset_size: Optional[int] = None,
) -> Tuple[float, float]:
    """Single-model evaluation -> (accuracy, mean_loss).
    ``forward_fn(params, images) -> logits [B, K]``; ``batches`` yields
    (images, labels) tensors. Normalization is by ``dataset_size`` (the
    reference divides by ``len(eval_loader.dataset)``), defaulting to the
    number of examples seen."""
    correct = loss = None
    seen = 0
    with torch.inference_mode():
        for images, labels in batches:
            c, l = eval_step_metrics(forward_fn(params, images), labels)
            correct = c if correct is None else correct + c
            loss = l if loss is None else loss + l
            seen += len(labels)
    n = dataset_size if dataset_size is not None else seen
    acc = float(correct) / n
    mean_loss = float(loss) / n
    if np.isnan(mean_loss):
        # reference NaN guard (utils.py:918-922)
        raise FloatingPointError(f"NaN validation loss (acc={acc}, n={n})")
    return acc, mean_loss


def device_memory_bytes(device) -> float:
    """The memory the evaluation may plan for: the card's total memory
    (``torch.cuda.mem_get_info``) for a CUDA device, the host's physical
    memory for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def suggest_coalition_chunk(
    seq_len: int,
    hidden: int,
    batch_size: int,
    device="cuda",
    mem_bytes: Optional[float] = None,
    activation_multiplier: float = 20.0,
    safety: float = 0.6,
    act_bytes: int = 2,
) -> int:
    """Memory-aware coalition-axis chunk size: live activations scale as
    roughly C·B·N·D·act_bytes·multiplier, and the chunk keeps them under
    ``safety`` of the device's memory (``mem_bytes``, read from ``device``
    when None). The JAX package's calibration (multiplier 20, safety 0.6) is
    kept. The attention kernel keeps the scores on chip; the bf16 MLP
    kernels write the LN output and the hidden to device memory (2·D + 8·D
    bytes a token for one block at a time), which stays inside the
    calibration's 20 × 2·D bytes a token. Always >= 1; the evaluator only
    splits when the coalition count exceeds it."""
    if mem_bytes is None:
        mem_bytes = device_memory_bytes(device)
    per_coalition = batch_size * seq_len * hidden * act_bytes * activation_multiplier
    return max(1, int(safety * mem_bytes / per_coalition))


def make_coalition_evaluator(
    forward_fn: Callable[[Tree, Tree, torch.Tensor], torch.Tensor],
    coalition_chunk: int = 0,
):
    """Build the batched primitive: evaluate C coalition models in one pass.

    ``forward_fn(shared, stacked_varying, images) -> logits [C, B, K]`` runs
    every coalition of a stacked per-coalition tree (leading C axis on every
    leaf — e.g. ``ops.materialize_coalitions`` output, or its merged q/v
    kernels); ``shared`` is the frozen base tree, passed once.

    Returns ``evaluate(shared, stacked_varying, batches, dataset_size=None)
    -> np.ndarray [C, 2]`` of (accuracy, mean_loss) rows (game2.py:106-110
    under utils_shapley.py:284-301, one pass instead of one per coalition).
    ``coalition_chunk > 0`` runs the coalition axis in chunks of that size to
    bound memory."""

    def evaluate(
        shared: Tree,
        stacked_varying: Tree,
        batches,
        dataset_size: Optional[int] = None,
    ) -> np.ndarray:
        C = tree_leaves(stacked_varying)[0].shape[0]
        if not isinstance(batches, (list, tuple)):
            batches = list(batches)  # every chunk must see the whole stream
        step = coalition_chunk if coalition_chunk and C > coalition_chunk else C
        corrects, losses = [], []
        seen = 0
        with torch.inference_mode():
            for s in range(0, C, step):
                chunk = tree_map(lambda leaf: leaf[s : s + step], stacked_varying)
                correct = loss = None
                seen = 0
                for images, labels in batches:
                    c, l = eval_step_metrics(forward_fn(shared, chunk, images), labels)
                    correct = c if correct is None else correct + c
                    loss = l if loss is None else loss + l
                    seen += len(labels)
                corrects.append(correct)
                losses.append(loss)
            correct = torch.cat(corrects).cpu().numpy()
            loss = torch.cat(losses).cpu().numpy()
        n = dataset_size if dataset_size is not None else seen
        acc = correct / np.float32(n)
        mean_loss = loss / np.float32(n)
        if np.isnan(mean_loss).any():
            bad = np.nonzero(np.isnan(mean_loss))[0].tolist()
            raise FloatingPointError(f"NaN validation loss for coalitions {bad}")
        return np.stack([acc, mean_loss], axis=1)

    return evaluate


class EvalBackend:
    """The drivers' evaluation surface on one device: the coalition
    evaluator, the upload of a validation set, and single-model evaluation
    through the same path (the single-device form of the JAX package's
    ``parallel.coalition_eval.EvalBackend``; the mesh-sharded form is a
    later slice).

    ``stack_single`` maps one model's overlay to a C=1 stacked varying tree
    for ``forward_fn`` (merged mode folds the overlay into q/v kernels, so
    the overlay cannot be fed directly); None stacks the overlay itself.
    """

    def __init__(self, forward_fn, coalition_chunk: int = 0, device="cuda",
                 stack_single: Optional[Callable[[Tree], Tree]] = None):
        self.device = torch.device(device)
        self.evaluate = make_coalition_evaluator(forward_fn, coalition_chunk=coalition_chunk)
        self._stack_single = stack_single or (lambda overlay: tree_map(lambda a: a[None], overlay))

    def device_batches(self, ds, batch_size: int) -> list:
        """Upload the validation set once; device-resident (images, labels)
        slices of at most ``batch_size``."""
        images = torch.as_tensor(ds.images, dtype=torch.float32).to(self.device)
        labels = torch.as_tensor(np.asarray(ds.labels), dtype=torch.long).to(self.device)
        return [
            (images[i : i + batch_size], labels[i : i + batch_size])
            for i in range(0, len(ds), batch_size)
        ]

    def evaluate_single(self, shared: Tree, varying: Tree, batches,
                        dataset_size: Optional[int] = None) -> Tuple[float, float]:
        """Single-model (accuracy, mean_loss) as a C=1 coalition stack."""
        row = self.evaluate(shared, self._stack_single(varying), batches,
                            dataset_size=dataset_size)[0]
        return float(row[0]), float(row[1])
