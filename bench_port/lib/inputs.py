"""Inputs made from the seed that every model family shares: the LoRA
overlay on q and v with the classifier, client deltas and images, drawn on
the run's device by one ``torch.Generator`` in a few large calls, in
float32 (the weights' type; the program casts to its compute dtype itself).
A family's base weights are its own (``families/<reference>.py``,
``base``), drawn from the same generator first.

Shapes come from the family's ``dims``: width ``D``, depth ``L``, classes
``K``, LoRA rank ``r``, the classifier's input width ``head_in``, and for
the images their side ``image``, patch ``P`` and channels ``C``. The trees
have the program's key names and layouts (leaves stacked on a leading depth
axis, kernels ``[in, out]``), so the same tensors go to the program and to
the plain reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# weights: normal of std 0.02 cut at two standard deviations (the HF
# initializer's scale); LayerNorm scales near 1, biases small
STD = 0.02


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


def _split(flat: torch.Tensor, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for k, shape in shapes.items():
        n = int(np.prod(shape))
        out[k] = flat[at:at + n].view(shape)
        at += n
    return out


def init_overlay(d: dict, base: dict, gen: torch.Generator, device) -> dict:
    """The trainable overlay at its start (peft's init): A uniform with
    bound sqrt(1 / hidden), B zero, the classifier a copy of the base's,
    which is ``[head_in, K]``."""
    D, L, r = d["D"], d["L"], d["r"]
    head = tuple(base["classifier"]["kernel"].shape)
    if head != (d["head_in"], d["K"]):
        raise ValueError(f"the base's classifier is {head}, the family's dims say "
                         f"{(d['head_in'], d['K'])}")
    bound = (1.0 / D) ** 0.5
    a = torch.empty(2 * L * D * r, device=device).uniform_(-bound, bound, generator=gen)
    a = a.view(2, L, D, r)
    zeros = torch.zeros(2, L, r, D, device=device)
    return {"lora": {"q": {"A": a[0], "B": zeros[0]}, "v": {"A": a[1], "B": zeros[1]}},
            "classifier": {"kernel": base["classifier"]["kernel"].clone(),
                           "bias": base["classifier"]["bias"].clone()}}


def client_deltas(d: dict, n: int, gen: torch.Generator, device, scale: dict) -> List[dict]:
    """``n`` client deltas of the overlay, as host numpy trees (what the
    server ingests): normal draws of std ``scale["A"]``, ``scale["B"]``,
    ``scale["classifier"]`` by leaf kind, in one draw."""
    D, L, r, K = d["D"], d["L"], d["r"], d["K"]
    shapes = {"qA": (n, L, D, r), "qB": (n, L, r, D), "vA": (n, L, D, r), "vB": (n, L, r, D),
              "ck": (n, d["head_in"], K), "cb": (n, K)}
    std = {"qA": scale["A"], "vA": scale["A"], "qB": scale["B"], "vB": scale["B"],
           "ck": scale["classifier"], "cb": scale["classifier"]}
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    parts = _split(flat, shapes)
    host = {k: (v * std[k]).cpu().numpy() for k, v in parts.items()}
    return [{"lora": {"q": {"A": host["qA"][i], "B": host["qB"][i]},
                      "v": {"A": host["vA"][i], "B": host["vB"][i]}},
             "classifier": {"kernel": host["ck"][i], "bias": host["cb"][i]}} for i in range(n)]


def images(d: dict, count: int, gen: torch.Generator, device, classes: int):
    """``count`` images ``[count, H, W, C]`` in [0, 1] with balanced labels in
    a seeded order: a per-class pattern constant over each patch, plus
    per-pixel noise (a stand-in for OCT scans: the classes differ in
    structure, the images in detail)."""
    H, P, C = d["image"], d["P"], d["C"]
    g = H // P
    protos = torch.randn(classes, g, g, C, generator=gen, device=device)
    protos = protos.repeat_interleave(P, dim=1).repeat_interleave(P, dim=2)
    labels = torch.arange(count, device=device) % classes
    labels = labels[torch.randperm(count, generator=gen, device=device)]
    noise = torch.randn(count, H, H, C, generator=gen, device=device)
    x = (0.5 + 0.2 * protos[labels] + 0.15 * noise).clamp_(0.0, 1.0)
    return x, labels
