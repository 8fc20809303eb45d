"""Array-backed datasets (a copy of ``shapley_vit_tpu/data/arrays.py``
without its JAX upload helpers: the evaluator uploads a validation set to
the card itself, ``fl.evaluation.EvalBackend.device_batches``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ArrayDataset:
    """Images [N,H,W,C] float32 (or features [N,D] for tabular), labels [N]
    int, optional per-sample names (the reference's sample schema is
    ``{'image','label','image_name'}``, start.py:295-301, utils.py:880)."""

    images: np.ndarray
    labels: np.ndarray
    names: Optional[List[str]] = None
    classes: Optional[List[str]] = None
    group: Optional[np.ndarray] = None  # sensitive-group id for fairness evals

    def __post_init__(self):
        if len(self.images) != len(self.labels):
            raise ValueError("images and labels differ in length")
        if self.names is not None and len(self.names) != len(self.labels):
            raise ValueError("names and labels differ in length")

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_classes(self) -> int:
        if self.classes is not None:
            return len(self.classes)
        return int(self.labels.max()) + 1 if len(self.labels) else 0

    def subset(self, indices: Sequence[int]) -> "ArrayDataset":
        """Reference CustomSubset equivalent (utils.py:488-500)."""
        idx = np.asarray(indices)
        return ArrayDataset(
            images=self.images[idx],
            labels=self.labels[idx],
            names=[self.names[i] for i in idx] if self.names is not None else None,
            classes=self.classes,
            group=self.group[idx] if self.group is not None else None,
        )

    def split(self, test_size: float, seed: int = 42, stratify: bool = True):
        """Stratified train/val split (reference start.py:40 uses sklearn
        train_test_split with stratify; CIFAR val split at utils.py:300-348
        uses a seeded 50/50 split)."""
        rng = np.random.default_rng(seed)
        n = len(self)
        if stratify:
            train_idx, test_idx = [], []
            for c in np.unique(self.labels):
                idx_c = np.where(self.labels == c)[0]
                rng.shuffle(idx_c)
                k = int(round(len(idx_c) * test_size))
                test_idx.extend(idx_c[:k])
                train_idx.extend(idx_c[k:])
            train_idx, test_idx = np.sort(train_idx), np.sort(test_idx)
        else:
            perm = rng.permutation(n)
            k = int(round(n * test_size))
            test_idx, train_idx = perm[:k], perm[k:]
        return self.subset(train_idx), self.subset(test_idx)


def batches(
    ds: ArrayDataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield host (images, labels) minibatches."""
    images, labels = ds.images, ds.labels
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        idx = order[i : i + batch_size]
        if shuffle:
            yield images[idx], labels[idx]
        else:
            yield images[i : i + batch_size], labels[i : i + batch_size]
