"""Inputs made from the seed: the ViT's weights, the LoRA overlay, client
deltas and images, drawn on the run's device by one ``torch.Generator`` in
a few large calls, in float32 (the weights' type; the program casts to its
compute dtype itself).

The trees have the program's key names and layouts (encoder leaves stacked
on a leading depth axis, kernels ``[in, out]``), so the same tensors go to
the program and to the plain reference.
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


def dims(cfg: dict) -> dict:
    P = cfg["patch_size"]
    NP = (cfg["image_size"] // P) ** 2
    return dict(D=cfg["hidden_size"], L=cfg["num_hidden_layers"], M=cfg["intermediate_size"], P=P,
                N=NP + 1, C=cfg["num_channels"], K=cfg["num_labels"], r=cfg["lora_r"],
                image=cfg["image_size"])


def vit_base(cfg: dict, gen: torch.Generator, device) -> dict:
    """The frozen base tree, in three draws: every matrix, every bias, every
    LayerNorm parameter."""
    d = dims(cfg)
    D, L, M, P, C, K, N = d["D"], d["L"], d["M"], d["P"], d["C"], d["K"], d["N"]
    mats = {"patch": (P * P * C, D), "cls": (1, 1, D), "pos": (1, N, D),
            "q": (L, D, D), "k": (L, D, D), "v": (L, D, D), "out": (L, D, D),
            "fc1": (L, D, M), "fc2": (L, M, D), "head": (D, K)}
    biases = {"patch": (D,), "q": (L, D), "k": (L, D), "v": (L, D), "out": (L, D),
              "fc1": (L, M), "fc2": (L, D), "head": (K,)}
    norms = {"ln1s": (L, D), "ln1b": (L, D), "ln2s": (L, D), "ln2b": (L, D), "fs": (D,), "fb": (D,)}

    def draw(shapes, std):
        n = sum(int(np.prod(s)) for s in shapes.values())
        flat = torch.randn(n, generator=gen, device=device).mul_(std).clamp_(-2 * std, 2 * std)
        return _split(flat, shapes)

    w = draw(mats, STD)
    b = draw(biases, STD)
    ln = draw(norms, 0.1)
    for k in ("ln1s", "ln2s", "fs"):
        ln[k] = ln[k] + 1.0

    def dense(name):
        return {"kernel": w[name], "bias": b[name]}

    return {
        "patch_embed": dense("patch"),
        "cls_token": w["cls"],
        "pos_embed": w["pos"],
        "blocks": {
            "ln1": {"scale": ln["ln1s"], "bias": ln["ln1b"]},
            "attn": {n: dense(n) for n in ("q", "k", "v", "out")},
            "ln2": {"scale": ln["ln2s"], "bias": ln["ln2b"]},
            "mlp": {"fc1": dense("fc1"), "fc2": dense("fc2")},
        },
        "final_ln": {"scale": ln["fs"], "bias": ln["fb"]},
        "classifier": dense("head"),
    }


def init_overlay(cfg: dict, base: dict, gen: torch.Generator, device) -> dict:
    """The trainable overlay at its start (peft's init): A uniform with
    bound sqrt(1 / hidden), B zero, the classifier a copy of the base's."""
    d = dims(cfg)
    D, L, r = d["D"], d["L"], d["r"]
    bound = (1.0 / D) ** 0.5
    a = torch.empty(2 * L * D * r, device=device).uniform_(-bound, bound, generator=gen)
    a = a.view(2, L, D, r)
    zeros = torch.zeros(2, L, r, D, device=device)
    return {"lora": {"q": {"A": a[0], "B": zeros[0]}, "v": {"A": a[1], "B": zeros[1]}},
            "classifier": {"kernel": base["classifier"]["kernel"].clone(),
                           "bias": base["classifier"]["bias"].clone()}}


def client_deltas(cfg: dict, n: int, gen: torch.Generator, device, scale: dict) -> List[dict]:
    """``n`` client deltas of the overlay, as host numpy trees (what the
    server ingests): normal draws of std ``scale["A"]``, ``scale["B"]``,
    ``scale["classifier"]`` by leaf kind, in one draw."""
    d = dims(cfg)
    D, L, r, K = d["D"], d["L"], d["r"], d["K"]
    shapes = {"qA": (n, L, D, r), "qB": (n, L, r, D), "vA": (n, L, D, r), "vB": (n, L, r, D),
              "ck": (n, D, K), "cb": (n, K)}
    std = {"qA": scale["A"], "vA": scale["A"], "qB": scale["B"], "vB": scale["B"],
           "ck": scale["classifier"], "cb": scale["classifier"]}
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    parts = _split(flat, shapes)
    host = {k: (v * std[k]).cpu().numpy() for k, v in parts.items()}
    return [{"lora": {"q": {"A": host["qA"][i], "B": host["qB"][i]},
                      "v": {"A": host["vA"][i], "B": host["vB"][i]}},
             "classifier": {"kernel": host["ck"][i], "bias": host["cb"][i]}} for i in range(n)]


def images(cfg: dict, count: int, gen: torch.Generator, device, classes: int):
    """``count`` images ``[count, H, W, C]`` in [0, 1] with balanced labels in
    a seeded order: a per-class pattern constant over each patch, plus
    per-pixel noise (a stand-in for OCT scans: the classes differ in
    structure, the images in detail)."""
    d = dims(cfg)
    H, P, C = d["image"], d["P"], d["C"]
    g = H // P
    protos = torch.randn(classes, g, g, C, generator=gen, device=device)
    protos = protos.repeat_interleave(P, dim=1).repeat_interleave(P, dim=2)
    labels = torch.arange(count, device=device) % classes
    labels = labels[torch.randperm(count, generator=gen, device=device)]
    noise = torch.randn(count, H, H, C, generator=gen, device=device)
    x = (0.5 + 0.2 * protos[labels] + 0.15 * noise).clamp_(0.0, 1.0)
    return x, labels
