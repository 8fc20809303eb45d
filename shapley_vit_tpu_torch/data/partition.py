"""Non-IID client partitioner: the Dirichlet label split that the client
driver and the demo use to give each client its shard.

A copy of ``_dirichlet_round`` and ``partition_labeldir`` from
``shapley_vit_tpu/data/partition.py`` (reference
federated_learning/utils.py:512-557): per-class Dirichlet proportions, the
capacity guard ``len(idx_j) < N/n``, the min-size retry loop with the
proportions kept fixed, and an explicit ``np.random.Generator``. The same
seed gives the same client mappings, index for index.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _dirichlet_round(
    targets: np.ndarray,
    num_classes: int,
    n_parties: int,
    distributions: np.ndarray,
    rng: np.random.Generator,
) -> List[List[int]]:
    """One allocation pass (the inner loop of utils.py:540-551): per class,
    shuffle indices and split by the Dirichlet proportions, zeroing parties
    already at capacity N/n."""
    N = targets.shape[0]
    idx_batch: List[List[int]] = [[] for _ in range(n_parties)]
    for k in range(num_classes):
        idx_k = np.where(targets == k)[0]
        rng.shuffle(idx_k)
        proportions = distributions[k]
        proportions = np.array(
            [p * (len(idx_j) < N / n_parties) for p, idx_j in zip(proportions, idx_batch)]
        )
        proportions = proportions / proportions.sum()
        cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
        idx_batch = [
            idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts))
        ]
    return idx_batch


def partition_labeldir(
    targets: np.ndarray,
    num_classes: int = 10,
    n_parties: int = 10,
    beta: float = 1.0,
    distributions: Optional[np.ndarray] = None,
    seed: int = 42,
    min_require_size: int = 10,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Dict[int, List[int]]]:
    """Dirichlet label partition with min-size retry (utils.py:512-557).
    Returns (the [num_classes, n_parties] proportions, {client: indices}).
    ``rng`` overrides the seeded generator (only ``shuffle`` and
    ``dirichlet`` are drawn, so a ``np.random.RandomState`` works too)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    targets = np.asarray(targets)
    if distributions is None:
        distributions = rng.dirichlet(np.repeat(beta, n_parties), num_classes)

    min_size = 0
    while min_size < min_require_size:
        # a retry keeps the distributions and reshuffles the class indices
        idx_batch = _dirichlet_round(targets, num_classes, n_parties, distributions, rng)
        min_size = min(len(idx_j) for idx_j in idx_batch)

    net_dataidx_map = {}
    for j in range(n_parties):
        arr = np.array(idx_batch[j])
        rng.shuffle(arr)
        net_dataidx_map[j] = arr.tolist()
    return distributions, net_dataidx_map
