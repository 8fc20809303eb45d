"""Dataset registry — the OCT entry the Shapley driver loads.

A copy of the OCT part of ``shapley_vit_tpu/data/registry.py``: the OCT
``CellData`` folder when ``data_dir`` holds it, otherwise (with
``synthetic_ok=True``) a deterministic class-separable synthetic stand-in of
the real shape (256×256×3, 4 classes, 2000 train / 400 validation images at
``synthetic_scale=1``). The same name, seed and scale give the same arrays
as the JAX package's registry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.data.oct import CellDataset

# name: (num_classes, H, W, C, train_n, test_n)  (sizes for synthetics)
_OCT_SPEC = (4, 256, 256, 3, 2000, 400)


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


def get_dataset(
    name: str,
    data_dir: Optional[str] = None,
    synthetic_ok: bool = True,
    synthetic_scale: float = 0.02,
    seed: int = 42,
) -> Tuple[Dict[str, ArrayDataset], Dict]:
    """Load the OCT dataset (``"oct"``, or its aliases ``"x-ray"`` and
    ``"cell"``). ``synthetic_scale`` shrinks the synthetic set sizes."""
    name = name.lower()
    if name not in ("oct", "x-ray", "cell"):
        raise ValueError(f"unknown dataset {name!r} (this package carries the OCT entry only)")
    try:
        full = CellDataset(data_dir or "", mode="train", patch_size=256)
        train, val = full.split(test_size=0.2, seed=42)
        info = dict(num_classes=full.num_classes, im_size=(256, 256), channels=3,
                    classes=full.classes)
        return dict(train=train, val=val, test=val), info
    except FileNotFoundError:
        if not synthetic_ok:
            raise
    num_classes, h, w, c, train_n, test_n = _OCT_SPEC
    train_n = max(num_classes * 10, int(train_n * synthetic_scale))
    test_n = max(num_classes * 10, int(test_n * synthetic_scale))
    train = _synthetic_images("oct", train_n, num_classes, h, w, c, seed)
    test = _synthetic_images("oct", test_n, num_classes, h, w, c, seed + 1)
    info = dict(num_classes=num_classes, im_size=(h, w), channels=c)
    return dict(train=train, val=test, test=test), info
