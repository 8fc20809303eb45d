"""Medical dataset loaders (a copy of ``shapley_vit_tpu/data/medical.py``).

Reference: ``federated_learning/utils.py:87-248`` — ``MyIsic`` (ISIC-2019:
image directory + CSV of one-hot diagnosis labels, utils.py:87-140),
``DrKaggle`` (diabetic retinopathy: trainLabels.csv with image/level columns,
utils.py:142-210), and the COVID ``ImageFolder`` loader (utils.py:212-248).

All load eagerly into :class:`ArrayDataset` (decoded once on the host). Each raises FileNotFoundError when the on-disk layout is absent —
callers fall back to the registry's synthetic stand-ins.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np

from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.data.oct import CellDataset, _load_image

ISIC_CLASSES = ["MEL", "NV", "BCC", "AK", "BKL", "DF", "VASC", "SCC"]


def load_isic(
    root: str, image_size: int = 224, max_samples: Optional[int] = None
) -> ArrayDataset:
    """ISIC-2019 (utils.py:87-140): ``<root>/ISIC_2019_Training_Input/*.jpg``
    + ``ISIC_2019_Training_GroundTruth.csv`` with one-hot columns per class."""
    csv_path = os.path.join(root, "ISIC_2019_Training_GroundTruth.csv")
    img_dir = os.path.join(root, "ISIC_2019_Training_Input")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(csv_path)
    images, labels, names = [], [], []
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        class_cols = [c for c in ISIC_CLASSES if c in (reader.fieldnames or [])]
        for row in reader:
            name = row["image"]
            onehot = [float(row[c]) for c in class_cols]
            if sum(onehot) == 0:
                continue
            path = os.path.join(img_dir, name + ".jpg")
            if not os.path.exists(path):
                continue
            images.append(_load_image(path, image_size))
            labels.append(int(np.argmax(onehot)))
            names.append(name)
            if max_samples and len(images) >= max_samples:
                break
    if not images:
        raise FileNotFoundError(f"no ISIC images under {img_dir}")
    return ArrayDataset(
        images=np.stack(images), labels=np.asarray(labels, np.int32),
        names=names, classes=class_cols,
    )


def load_dr_kaggle(
    root: str, image_size: int = 224, max_samples: Optional[int] = None
) -> ArrayDataset:
    """DR-Kaggle (utils.py:142-210): ``<root>/train/<image>.jpeg`` +
    ``trainLabels.csv`` with image,level columns (levels 0-4)."""
    csv_path = os.path.join(root, "trainLabels.csv")
    img_dir = os.path.join(root, "train")
    if not os.path.exists(csv_path):
        raise FileNotFoundError(csv_path)
    images, labels, names = [], [], []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            name, level = row["image"], int(row["level"])
            path = os.path.join(img_dir, name + ".jpeg")
            if not os.path.exists(path):
                continue
            images.append(_load_image(path, image_size))
            labels.append(level)
            names.append(name)
            if max_samples and len(images) >= max_samples:
                break
    if not images:
        raise FileNotFoundError(f"no DR-Kaggle images under {img_dir}")
    return ArrayDataset(
        images=np.stack(images), labels=np.asarray(labels, np.int32),
        names=names, classes=[str(i) for i in range(5)],
    )


def load_imagefolder(
    root: str, image_size: int = 224, classes: Optional[List[str]] = None,
    max_per_class: Optional[int] = None,
) -> ArrayDataset:
    """Generic torchvision-ImageFolder layout (the reference's COVID loader,
    utils.py:212-248): ``<root>/<CLASS>/*`` with sorted class order."""
    return CellDataset(
        root, mode="", patch_size=image_size, classes=classes,
        max_per_class=max_per_class,
    )
