"""Non-IID client partitioners: the Dirichlet label splits, the per-client
class histograms and the per-client subsets.

A copy of ``shapley_vit_tpu/data/partition.py`` (reference
federated_learning/utils.py:512-669): per-class Dirichlet proportions, the
capacity guard ``len(idx_j) < N/n``, the min-size retry loop with the
proportions kept fixed (fresh ones per retry in the medical variant), the
guaranteed-min-class-size adjustment, and an explicit
``np.random.Generator``. The same seed gives the same client mappings, index
for index.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# per-medical-dataset class counts (reference utils.py:607-625)
MED_NUM_CLASSES = {
    "isic2019": 8,
    "dr-kaggle": 5,
    "covid-19": 3,
    "organamnist": 11,
    "organcmnist": 11,
    "organsmnist": 11,
    "pathmnist": 9,
    "bloodmnist": 8,
    "tissuemnist": 8,
    "dermamnist": 7,
    "octmnist": 4,
    "pneumoniamnist": 2,
    "breastmnist": 2,
}


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


def partition_labeldir2(
    targets: np.ndarray,
    num_classes: int = 10,
    n_parties: int = 10,
    beta: float = 1.0,
    distributions: Optional[np.ndarray] = None,
    min_class_size: int = 10,
    seed: int = 42,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Dict[int, List[int]]]:
    """Dirichlet partition guaranteeing each split of each class has at least
    ``min_class_size`` samples where possible (utils.py:559-593). ``rng`` as
    in :func:`partition_labeldir` (the reference never seeds here — it draws
    from ambient global state, utils.py:559)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    targets = np.asarray(targets)
    N = targets.shape[0]
    if distributions is None:
        distributions = rng.dirichlet(np.repeat(beta, n_parties), num_classes)

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
        # min-class-size adjustment (utils.py:580-586)
        cuts = np.concatenate([[0], cuts])
        for i in range(1, len(cuts)):
            if cuts[i] - cuts[i - 1] < min_class_size and cuts[i] < len(idx_k):
                diff = min(min_class_size - (cuts[i] - cuts[i - 1]), len(idx_k) - cuts[i])
                cuts[i:] += diff
        idx_batch = [
            idx_j + idx.tolist()
            for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts[1:]))
        ]

    net_dataidx_map = {}
    for j in range(n_parties):
        arr = np.array(idx_batch[j])
        rng.shuffle(arr)
        net_dataidx_map[j] = arr.tolist()
    return distributions, net_dataidx_map


def partition_labeldir_med(
    dataset_name: str,
    y_train: np.ndarray,
    n_parties: int,
    beta: float = 0.1,
    seed: int = 42,
    min_require_size: int = 10,
) -> Dict[int, List[int]]:
    """Medical-dataset variant (utils.py:596-644): class count from the
    dataset name; fresh Dirichlet proportions per retry (unlike
    partition_labeldir, which keeps them fixed)."""
    if dataset_name not in MED_NUM_CLASSES:
        raise ValueError(f"unknown medical dataset {dataset_name!r}")
    K = MED_NUM_CLASSES[dataset_name]
    rng = np.random.default_rng(seed)
    y_train = np.asarray(y_train)

    min_size = 0
    while min_size < min_require_size:
        distributions = np.stack(
            [rng.dirichlet(np.repeat(beta, n_parties)) for _ in range(K)]
        )
        idx_batch = _dirichlet_round(y_train, K, n_parties, distributions, rng)
        min_size = min(len(idx_j) for idx_j in idx_batch)

    net_dataidx_map = {}
    for j in range(n_parties):
        arr = np.array(idx_batch[j])
        rng.shuffle(arr)
        net_dataidx_map[j] = arr.tolist()
    return net_dataidx_map


def record_net_data_stats(
    y_train: np.ndarray, net_dataidx_map: Optional[Dict[int, List[int]]], logger=None
):
    """Per-client class histograms (utils.py:646-663)."""
    net_cls_counts = {}
    y_train = np.asarray(y_train)
    if net_dataidx_map is not None:
        for net_i, dataidx in net_dataidx_map.items():
            unq, unq_cnt = np.unique(y_train[dataidx], return_counts=True)
            tmp = {int(unq[i]): int(unq_cnt[i]) for i in range(len(unq))}
            net_cls_counts[net_i] = tmp
            msg = "Client {:2d} total train data: {:5d}, distribution: {}".format(
                net_i, len(dataidx), tmp
            )
            if logger is not None:
                logger.info(msg)
    else:
        unq, unq_cnt = np.unique(y_train, return_counts=True)
        for i in range(len(unq)):
            net_cls_counts[int(unq[i])] = int(unq_cnt[i])
    return net_cls_counts


def make_client_datasets(dataset, num_clients: int, data_idcs: Dict[int, List[int]]):
    """Subset per client (utils.py:665-669 make_client_dataset_from_partition)."""
    return {cid: dataset.subset(data_idcs[cid]) for cid in range(num_clients)}
