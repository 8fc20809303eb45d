"""Dataset registry — ``get_dataset(name) -> (splits, info)`` (a copy of
``shapley_vit_tpu/data/registry.py``, with ``train=False``).

Reference: ``federated_learning/utils.py:250-486`` ``get_dataset`` with
MNIST / EMNIST / SVHN / CIFAR10 (50-50 train/val split, seed 42) / CIFAR100 /
CINIC10 / COMPAS / Adult (tabular with per-sensitive-group validation sets) /
medical loaders (ISIC-2019, DR-Kaggle, COVID ImageFolder) plus the OCT
CellData loader on the live path.

Nothing is downloaded: each image loader reads the standard on-disk layout if ``data_dir`` has it
(torchvision cache for MNIST-family/CIFAR/SVHN, ImageFolder for the medical
sets), and otherwise — when ``synthetic_ok=True`` (the default for smoke/test
runs) — generates a deterministic class-separable synthetic stand-in with the
real shape/class-count so every downstream path (partitioners, FL, Shapley)
exercises identically.

Returned ``splits`` dict: ``train`` / ``val`` / ``test`` ArrayDatasets (val
may equal test where the reference does that); ``info``: num_classes,
im_size, channels, and for tabular sets the per-group validation splits
(utils.py:394-455). The same name, seed and scale give the same arrays as
the JAX package's registry. ``train=False`` leaves a synthetic training
split out (no ``"train"`` key): the drivers that only evaluate skip it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.data.oct import CellDataset

_IMAGE_SPECS = {
    # name: (num_classes, H, W, C, train_n, test_n)  (sizes for synthetics)
    "mnist": (10, 28, 28, 1, 60000, 10000),
    "emnist": (47, 28, 28, 1, 112800, 18800),
    "svhn": (10, 32, 32, 3, 73257, 26032),
    "cifar10": (10, 32, 32, 3, 50000, 10000),
    "cifar100": (100, 32, 32, 3, 50000, 10000),
    "cinic10": (10, 32, 32, 3, 90000, 90000),
    "covid-19": (3, 224, 224, 3, 3000, 600),
    "isic2019": (8, 224, 224, 3, 20264, 5067),
    "dr-kaggle": (5, 224, 224, 3, 35126, 10000),
    "oct": (4, 256, 256, 3, 2000, 400),
}


def _synthetic_images(
    name: str, n: int, num_classes: int, h: int, w: int, c: int, seed: int
) -> ArrayDataset:
    """Deterministic, class-separable synthetic images: per-class mean
    pattern + noise, so accuracy is learnable and eval is non-degenerate.
    Class prototypes are keyed by the dataset NAME (shared across splits);
    only the noise/labels vary with ``seed``."""
    import zlib

    proto_rng = np.random.default_rng(zlib.crc32(name.encode()))  # stable across processes
    protos = proto_rng.normal(0.5, 0.15, size=(num_classes, h, w, c)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = protos[labels] + rng.normal(0, 0.1, size=(n, h, w, c)).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)
    names = [f"{name}_{i:06d}.synthetic" for i in range(n)]
    return ArrayDataset(images=images, labels=labels, names=names)


def _try_torchvision(name: str, data_dir: str):
    """Load from a local torchvision cache (download=False). Returns
    (train_ds, test_ds) ArrayDatasets or None."""
    try:
        import torchvision
        import torchvision.transforms  # noqa: F401
    except Exception:
        return None

    def to_arrays(tv) -> ArrayDataset:
        xs, ys = [], []
        for img, y in tv:
            raw = np.asarray(img)
            arr = raw.astype(np.float32)
            # scale by DTYPE, not by value: a dark uint8 image (max 0 or 1
            # — all-black SVHN crops, sparse medical frames) must still be
            # divided by 255 or it enters training up to 255x brighter
            # than its correctly scaled neighbors
            if raw.dtype == np.uint8:
                arr = arr / 255.0
            if arr.ndim == 2:
                arr = arr[..., None]
            xs.append(arr)
            ys.append(int(y))
        return ArrayDataset(images=np.stack(xs), labels=np.asarray(ys, np.int32))

    try:
        tv = torchvision.datasets
        if name == "mnist":
            pair = tv.MNIST(data_dir, train=True, download=False), tv.MNIST(data_dir, train=False, download=False)
        elif name == "emnist":
            pair = (
                tv.EMNIST(data_dir, split="balanced", train=True, download=False),
                tv.EMNIST(data_dir, split="balanced", train=False, download=False),
            )
        elif name == "svhn":
            pair = tv.SVHN(data_dir, split="train", download=False), tv.SVHN(data_dir, split="test", download=False)
        elif name == "cifar10":
            pair = tv.CIFAR10(data_dir, train=True, download=False), tv.CIFAR10(data_dir, train=False, download=False)
        elif name == "cifar100":
            pair = tv.CIFAR100(data_dir, train=True, download=False), tv.CIFAR100(data_dir, train=False, download=False)
        else:
            return None
        return to_arrays(pair[0]), to_arrays(pair[1])
    except Exception:
        return None


def _try_disk_folders(name: str, data_dir: str, image_size: int):
    """On-disk loaders for layouts torchvision can't fetch here:
    CINIC-10 ``{train,valid,test}/<class>/*`` directory trees (reference
    utils.py:375-392), COVID ``{train,test}/<class>`` ImageFolder
    (utils.py:212-248), ISIC-2019 CSV+images (utils.py:87-140), DR-Kaggle
    trainLabels.csv (utils.py:142-210). Returns (train, val, test)
    ArrayDatasets or None when the layout is absent."""
    from shapley_vit_tpu_torch.data.medical import (
        load_dr_kaggle,
        load_imagefolder,
        load_isic,
    )

    try:
        if name == "cinic10":
            root = data_dir
            if not os.path.isdir(os.path.join(root, "train")):
                for sub in ("cinic10", "CINIC-10"):
                    cand = os.path.join(data_dir, sub)
                    if os.path.isdir(os.path.join(cand, "train")):
                        root = cand
                        break
                else:
                    return None
            train = load_imagefolder(os.path.join(root, "train"), image_size)
            # thread the TRAIN split's class order into the other splits: a
            # split directory missing a class folder would otherwise derive
            # its own sorted mapping and silently misalign labels
            classes = train.classes
            test = load_imagefolder(os.path.join(root, "test"), image_size, classes=classes)
            val_dir = os.path.join(root, "valid")
            val = (
                load_imagefolder(val_dir, image_size, classes=classes)
                if os.path.isdir(val_dir)
                else test
            )
            return train, val, test
        if name == "covid-19":
            if not os.path.isdir(os.path.join(data_dir, "train")):
                return None
            train = load_imagefolder(os.path.join(data_dir, "train"), image_size)
            test = load_imagefolder(
                os.path.join(data_dir, "test"), image_size, classes=train.classes
            )
            return train, test, test
        if name == "isic2019":
            full = load_isic(data_dir, image_size)
            train, test = full.split(test_size=0.2, seed=42, stratify=True)
            return train, test, test
        if name == "dr-kaggle":
            full = load_dr_kaggle(data_dir, image_size)
            train, test = full.split(test_size=0.2, seed=42, stratify=True)
            return train, test, test
    except FileNotFoundError:
        return None
    return None


def _tabular(name: str, data_dir: str, synthetic_ok: bool, seed: int):
    """COMPAS / Adult tabular sets with a binary sensitive attribute and
    per-group validation splits (utils.py:394-455)."""
    n_features = 12 if name == "compas" else 14
    csv = os.path.join(data_dir or "", f"{name}.csv")
    if os.path.exists(csv):
        raw = np.atleast_2d(np.genfromtxt(csv, delimiter=",", skip_header=1))
        if raw.shape[1] < 3:
            raise ValueError(
                f"{csv}: expected >= 3 numeric columns "
                "(features..., group, label)"
            )
        if not np.isfinite(raw).all():
            # genfromtxt turns non-numeric cells into NaN — a raw adult.csv
            # with string categoricals would otherwise train on all-NaN
            # features with no error
            raise ValueError(
                f"{csv} contains non-numeric/missing cells; the loader "
                "expects a fully numeric preprocessed CSV "
                "(features..., group, label)"
            )
        X = raw[:, :-2].astype(np.float32)
        group = raw[:, -2].astype(np.int32)
        y = raw[:, -1].astype(np.int32)
    elif synthetic_ok:
        rng = np.random.default_rng(seed)
        n = 5000
        X = rng.normal(size=(n, n_features)).astype(np.float32)
        group = (rng.random(n) < 0.4).astype(np.int32)
        w = rng.normal(size=n_features)
        y = ((X @ w + 0.3 * group + rng.normal(0, 0.5, n)) > 0).astype(np.int32)
    else:
        raise FileNotFoundError(f"{csv} not found and synthetic_ok=False")

    ds = ArrayDataset(images=X, labels=y, group=group, classes=["neg", "pos"])
    train, valtest = ds.split(test_size=0.4, seed=42, stratify=True)
    val, test = valtest.split(test_size=0.5, seed=42, stratify=True)
    group_val = [val.subset(np.where(val.group == g)[0]) for g in (0, 1)]
    info = dict(
        num_classes=2, tabular=True, n_features=X.shape[1], group_valid=group_val
    )
    return dict(train=train, val=val, test=test), info


def get_dataset(
    name: str,
    data_dir: Optional[str] = None,
    synthetic_ok: bool = True,
    synthetic_scale: float = 0.02,
    seed: int = 42,
    train: bool = True,
) -> Tuple[Dict[str, ArrayDataset], Dict]:
    """Load a named dataset. ``synthetic_scale`` shrinks synthetic set sizes
    (the full MNIST-sized synthetics are pointless in tests); ``train=False``
    leaves a synthetic training split out (the validation and test splits
    are the same arrays either way)."""
    name = name.lower()
    data_dir = data_dir or ""

    if name in ("compas", "adult"):
        return _tabular(name, data_dir, synthetic_ok, seed)

    if name in ("oct", "x-ray", "cell"):
        try:
            full = CellDataset(data_dir, mode="train", patch_size=256)
            train_ds, val = full.split(test_size=0.2, seed=42)
            info = dict(num_classes=full.num_classes, im_size=(256, 256), channels=3,
                        classes=full.classes)
            return dict(train=train_ds, val=val, test=val), info
        except FileNotFoundError:
            if not synthetic_ok:
                raise
            name = "oct"  # aliases fall through to the synthetic OCT generator

    if name not in _IMAGE_SPECS:
        raise ValueError(f"unknown dataset {name!r}")
    num_classes, h, w, c, train_n, test_n = _IMAGE_SPECS[name]

    if data_dir:
        disk = _try_disk_folders(name, data_dir, image_size=h)
        if disk is not None:
            train_ds, val, test = disk
            info = dict(num_classes=num_classes, im_size=(h, w), channels=c)
            return dict(train=train_ds, val=val, test=test), info

    # native format readers first (data/formats.py: CIFAR pickles,
    # MNIST/EMNIST idx, SVHN .mat, no torchvision needed); a torchvision
    # cache is the optional fallback for layouts they do not cover
    loaded = None
    if data_dir:
        from shapley_vit_tpu_torch.data.formats import try_native_formats

        loaded = try_native_formats(name, data_dir)
        if loaded is None:
            loaded = _try_torchvision(name, data_dir)
    if loaded is not None:
        train_ds, test = loaded
    elif synthetic_ok:
        train_n = max(num_classes * 10, int(train_n * synthetic_scale))
        test_n = max(num_classes * 10, int(test_n * synthetic_scale))
        train_ds = (_synthetic_images(name, train_n, num_classes, h, w, c, seed)
                    if train else None)
        test = _synthetic_images(name, test_n, num_classes, h, w, c, seed + 1)
    else:
        raise FileNotFoundError(
            f"no local data for {name!r} under {data_dir!r} and synthetic_ok=False"
        )

    if name == "cifar10":
        # reference: CIFAR-10 test set split 50/50 into val/test, seed 42
        # (utils.py:300-348)
        val, test = test.split(test_size=0.5, seed=42, stratify=True)
    else:
        val = test
    info = dict(num_classes=num_classes, im_size=(h, w), channels=c)
    out = dict(val=val, test=test)
    if train_ds is not None:
        out["train"] = train_ds
    return out, info
