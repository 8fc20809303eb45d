"""Native readers for the classic benchmark dataset formats (a copy of
``shapley_vit_tpu/data/formats.py``).

The reference loads MNIST/EMNIST, SVHN, and CIFAR-10/100 through torchvision
caches (``federated_learning/utils.py:250-348``). The port needs no
torchvision, so these parse the standard on-disk formats directly: CIFAR
python pickles, MNIST/EMNIST idx (gzipped or raw), and
SVHN ``.mat`` (scipy.io). Layout conventions match the torchvision cache so
a directory populated by torchvision elsewhere loads here unchanged.

All readers return ``ArrayDataset`` pairs (train, test) with float32 [0, 1]
NHWC images and int32 labels, or raise ``FileNotFoundError`` when the layout
is absent (the registry then falls back to torchvision-if-importable, then
synthetic).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import List, Optional, Tuple

import numpy as np

from shapley_vit_tpu_torch.data.arrays import ArrayDataset


# ---------------------------------------------------------------------------
# idx (MNIST / EMNIST)
# ---------------------------------------------------------------------------

def _open_maybe_gz(path: str):
    """Open ``path`` or ``path + '.gz'`` (torchvision keeps both in raw/)."""
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path: str) -> np.ndarray:
    """Parse one idx file (the LeCun format): magic ``\\x00\\x00<dtype><ndim>``,
    big-endian int32 dims, raw data. Only the uint8 dtype (0x08) used by
    MNIST-family files is supported."""
    with _open_maybe_gz(path) as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise ValueError(f"{path}: not an idx file (magic {magic!r})")
        dtype_code, ndim = magic[2], magic[3]
        if dtype_code != 0x08:
            raise ValueError(f"{path}: unsupported idx dtype 0x{dtype_code:02x}")
        dims = struct.unpack(f">{ndim}i", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: size mismatch {data.size} vs dims {dims}")
    return data.reshape(dims)


def _idx_pair_to_dataset(
    images_path: str, labels_path: str, transpose: bool = False
) -> ArrayDataset:
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if images.ndim != 3:
        raise ValueError(f"{images_path}: expected [N, H, W], got {images.shape}")
    if transpose:
        # EMNIST raw images are stored transposed relative to MNIST
        # orientation; torchvision un-transposes on load — match it
        images = images.transpose(0, 2, 1)
    x = (images.astype(np.float32) / 255.0)[..., None]  # NHWC, C=1
    return ArrayDataset(images=x, labels=labels.astype(np.int32))


def load_mnist_idx(data_dir: str) -> Tuple[ArrayDataset, ArrayDataset]:
    """MNIST from idx files. Searches ``<data_dir>/MNIST/raw`` (the
    torchvision cache layout, reference utils.py:300-314) then ``data_dir``
    itself."""
    names = (
        "train-images-idx3-ubyte",
        "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte",
        "t10k-labels-idx1-ubyte",
    )
    for root in (os.path.join(data_dir, "MNIST", "raw"), data_dir):
        try:
            paths = [os.path.join(root, n) for n in names]
            train = _idx_pair_to_dataset(paths[0], paths[1])
            test = _idx_pair_to_dataset(paths[2], paths[3])
            return train, test
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no MNIST idx files under {data_dir!r}")


def load_emnist_idx(
    data_dir: str, split: str = "balanced"
) -> Tuple[ArrayDataset, ArrayDataset]:
    """EMNIST (default the 47-class ``balanced`` split the reference uses,
    utils.py:316-330) from ``<data_dir>/EMNIST/raw`` or ``data_dir``."""
    names = tuple(
        f"emnist-{split}-{part}-{kind}"
        for part in ("train", "test")
        for kind in ("images-idx3-ubyte", "labels-idx1-ubyte")
    )
    for root in (os.path.join(data_dir, "EMNIST", "raw"), data_dir):
        try:
            paths = [os.path.join(root, n) for n in names]
            train = _idx_pair_to_dataset(paths[0], paths[1], transpose=True)
            test = _idx_pair_to_dataset(paths[2], paths[3], transpose=True)
            return train, test
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no EMNIST ({split}) idx files under {data_dir!r}")


# ---------------------------------------------------------------------------
# CIFAR python pickles
# ---------------------------------------------------------------------------

def _cifar_batch(path: str, label_key: bytes) -> Tuple[np.ndarray, List[int]]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"], dtype=np.uint8)
    if data.ndim != 2 or data.shape[1] != 3072:
        raise ValueError(f"{path}: expected [N, 3072] data, got {data.shape}")
    labels = list(d[label_key])
    if len(labels) != data.shape[0]:
        raise ValueError(f"{path}: {len(labels)} labels for {data.shape[0]} rows")
    return data, labels


def _cifar_to_dataset(rows: np.ndarray, labels: List[int]) -> ArrayDataset:
    # rows are CHW-flattened RGB (the published format)
    x = rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    return ArrayDataset(images=x, labels=np.asarray(labels, np.int32))


def load_cifar10_pickles(data_dir: str) -> Tuple[ArrayDataset, ArrayDataset]:
    """CIFAR-10 from the published python pickle layout
    ``cifar-10-batches-py/{data_batch_1..5, test_batch}`` (the torchvision
    cache stores it verbatim; reference utils.py:332-348)."""
    for root in (os.path.join(data_dir, "cifar-10-batches-py"), data_dir):
        if not os.path.exists(os.path.join(root, "data_batch_1")):
            continue
        rows, labels = [], []
        for i in range(1, 6):
            r, l = _cifar_batch(os.path.join(root, f"data_batch_{i}"), b"labels")
            rows.append(r)
            labels += l
        train = _cifar_to_dataset(np.concatenate(rows), labels)
        r, l = _cifar_batch(os.path.join(root, "test_batch"), b"labels")
        return train, _cifar_to_dataset(r, l)
    raise FileNotFoundError(f"no cifar-10-batches-py layout under {data_dir!r}")


def load_cifar100_pickles(data_dir: str) -> Tuple[ArrayDataset, ArrayDataset]:
    """CIFAR-100 from ``cifar-100-python/{train, test}`` (fine labels, as
    torchvision returns; reference utils.py:350-373)."""
    for root in (os.path.join(data_dir, "cifar-100-python"), data_dir):
        if not os.path.exists(os.path.join(root, "train")):
            continue
        r, l = _cifar_batch(os.path.join(root, "train"), b"fine_labels")
        train = _cifar_to_dataset(r, l)
        r, l = _cifar_batch(os.path.join(root, "test"), b"fine_labels")
        return train, _cifar_to_dataset(r, l)
    raise FileNotFoundError(f"no cifar-100-python layout under {data_dir!r}")


# ---------------------------------------------------------------------------
# SVHN .mat
# ---------------------------------------------------------------------------

def load_svhn_mat(data_dir: str) -> Tuple[ArrayDataset, ArrayDataset]:
    """SVHN cropped-digits from ``{train,test}_32x32.mat`` directly under
    ``data_dir`` (where torchvision keeps them; reference utils.py:286-298).
    Stored as X[32, 32, 3, N], y in 1..10 with 10 meaning digit 0 — labels
    are remapped to 0..9 exactly as torchvision does."""
    from scipy.io import loadmat

    def one(split: str) -> ArrayDataset:
        path = os.path.join(data_dir, f"{split}_32x32.mat")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        mat = loadmat(path)
        X = np.asarray(mat["X"])
        y = np.asarray(mat["y"]).reshape(-1)
        if X.ndim != 4 or X.shape[:3] != (32, 32, 3):
            raise ValueError(f"{path}: expected X[32,32,3,N], got {X.shape}")
        x = X.transpose(3, 0, 1, 2).astype(np.float32) / 255.0
        return ArrayDataset(images=x, labels=(y % 10).astype(np.int32))

    return one("train"), one("test")


def try_native_formats(
    name: str, data_dir: str
) -> Optional[Tuple[ArrayDataset, ArrayDataset]]:
    """Dispatch: (train, test) for the five classic families when the
    standard on-disk layout is present under ``data_dir``, else None."""
    loaders = {
        "mnist": load_mnist_idx,
        "emnist": load_emnist_idx,
        "svhn": load_svhn_mat,
        "cifar10": load_cifar10_pickles,
        "cifar100": load_cifar100_pickles,
    }
    fn = loaders.get(name)
    if fn is None:
        return None
    try:
        return fn(data_dir)
    except FileNotFoundError:
        return None
