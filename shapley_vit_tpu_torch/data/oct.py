"""OCT retinal dataset loader — the re-specified ``CellDataLoader`` (a copy of
``shapley_vit_tpu/data/oct.py``).

The reference imports ``XrayDataLoader as CellDataLoader`` from a gitignored
module (``shapleyserver/datasets/dataloader_cell.py``, excluded by
``.gitignore``; import at start.py:1). Its contract is recovered from the
call sites (SURVEY.md §7 "hard parts"):

  * constructor ``(root_dir, mode, patch_size, sub_dir)`` (start.py:52-56)
  * directory layout ``root/<mode>/<CLASS>/*`` — the public OCT CellData
    release (classes CNV, DME, DRUSEN, NORMAL; start.py's ``.env``
    VALIDATION_DATASET points at ``.../CellData/OCT1/train``)
  * samples are dicts ``{'image','label','image_name'}`` (utils.py:880),
    images resized to ``patch_size``×``patch_size`` (opts.py:64 default 256)

Here the loader eagerly decodes into an :class:`ArrayDataset` (images
[N, P, P, 3] float32 in [0, 1], matching torchvision ``ToTensor`` scaling at
start.py:35-38) — one decode, then device-resident forever.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from shapley_vit_tpu_torch.data.arrays import ArrayDataset

OCT_CLASSES = ["CNV", "DME", "DRUSEN", "NORMAL"]
IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".tiff", ".tif", ".npy")


def _load_image(path: str, patch_size: int) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.shape[:2] != (patch_size, patch_size):
            arr = _resize_np(arr.astype(np.float32), patch_size)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        return arr
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((patch_size, patch_size), Image.BILINEAR)
        return np.asarray(im, dtype=np.float32) / 255.0


def _resize_np(arr: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour fallback resize without PIL."""
    h, w = arr.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return arr[ys][:, xs]


def CellDataset(
    root_dir: str,
    mode: str = "train",
    patch_size: int = 256,
    sub_dir: str = "",
    classes: Optional[Sequence[str]] = None,
    max_per_class: Optional[int] = None,
) -> ArrayDataset:
    """Load ``root_dir[/sub_dir]/<CLASS>/*`` (or ``root/<mode>/<CLASS>/*`` if
    present) into an ArrayDataset. ``max_per_class`` caps decode cost for
    smoke runs."""
    base = os.path.join(root_dir, sub_dir) if sub_dir else root_dir
    # the reference's .env points directly at .../train; accept either layout
    if os.path.isdir(os.path.join(base, mode)):
        base = os.path.join(base, mode)
    if not os.path.isdir(base):
        raise FileNotFoundError(f"OCT dataset root not found: {base}")

    if classes is None:
        found = sorted(
            d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
        )
        classes = found if found else OCT_CLASSES

    images: List[np.ndarray] = []
    labels: List[int] = []
    names: List[str] = []
    for label, cls in enumerate(classes):
        cls_dir = os.path.join(base, cls)
        if not os.path.isdir(cls_dir):
            continue
        files = sorted(
            f for f in os.listdir(cls_dir) if f.lower().endswith(IMAGE_EXTS)
        )
        if max_per_class is not None:
            files = files[:max_per_class]
        for fname in files:
            images.append(_load_image(os.path.join(cls_dir, fname), patch_size))
            labels.append(label)
            names.append(fname)
    if not images:
        raise FileNotFoundError(f"no images found under {base} for classes {classes}")
    return ArrayDataset(
        images=np.stack(images),
        labels=np.asarray(labels, dtype=np.int32),
        names=names,
        classes=list(classes),
    )
