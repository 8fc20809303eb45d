"""Batch preprocessing on the device: the port of
``shapley_vit_tpu/data/pipeline.py``.

Reference: torchvision transforms on the host per sample
(``Resize((256,256)) + ToTensor`` at start.py:35-38; per-dataset normalize
stacks in utils.py:250-486). Here decoding happens once on the host
(``data/oct.py``); resize, normalize and the dtype cast run on whole
batches on ``device``, and the result stays there for every coalition and
round. ``resize_batch`` is the port's one antialiased bilinear resize, the
same function as ``jax.image.resize(..., "bilinear")``;
``driver.start.resize_images`` runs it block by block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.data.arrays import ArrayDataset

# torchvision-style constants
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# HF ViTImageProcessor defaults (vit-base-patch16-224-in21k)
VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)


def resize_batch(images: torch.Tensor, size: int, method: str = "bilinear") -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C] (torchvision Resize semantics;
    antialiased when it shrinks, as ``jax.image.resize``)."""
    if method != "bilinear":
        raise ValueError(f"resize method {method!r}: the port resizes bilinear only")
    x = images.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def normalize_batch(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Per-channel (x - mean) / std (torchvision Normalize)."""
    return (images - mean.reshape(1, 1, 1, -1)) / std.reshape(1, 1, 1, -1)


def preprocess(
    images,
    size: Optional[int] = None,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """resize -> normalize -> cast on ``device`` (one upload of the
    batch)."""
    x = torch.as_tensor(np.asarray(images, np.float32) if not isinstance(images, torch.Tensor)
                        else images, device=device).float()
    if size is not None and x.shape[1] != size:
        x = resize_batch(x, size)
    if mean is not None:
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std or (1.0,) * len(mean), dtype=torch.float32, device=x.device)
        x = normalize_batch(x, m, s)
    return x.to(dtype)


def make_eval_batches(
    ds: ArrayDataset,
    batch_size: int,
    size: Optional[int] = None,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    device="cuda",
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Preprocess once, upload once, slice into batches on ``device``: the
    eval loop's input (the reference's DataLoader, start.py:84, re-reads
    and re-uploads per epoch per coalition)."""
    images = preprocess(ds.images, size=size, mean=mean, std=std, device=device)
    labels = torch.as_tensor(np.asarray(ds.labels), device=device)
    return [
        (images[i : i + batch_size], labels[i : i + batch_size])
        for i in range(0, len(ds), batch_size)
    ]
