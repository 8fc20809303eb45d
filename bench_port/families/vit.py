"""The ViT family: HF ``ViTForImageClassification`` as the program runs it
(``shapley_vit_tpu_torch/models/vit.py``): a pre-LN block with an erf-GELU
MLP, learned positions with CLS, the classifier on the CLS row.

What the harness knows of this block lives here, found by a configuration's
``"reference": "vit"`` (``cell.family_module``): the program's spec built
from the configuration's keys, the base weights drawn from the seed, the
operations of its work counted from its shapes, the program's kernel
wrappers and kernel-name fragments, the one-model forward that training
differentiates, and the tiny sizes of the CPU tests.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bench_port.lib import counts
from bench_port.lib.inputs import STD, _split

# the program's kernel wrappers whose launches a traced window counts, as
# (module, attribute)
WRAPPERS = (("shapley_vit_tpu_torch.ops.patch_embed", "patch_embed"),
            ("shapley_vit_tpu_torch.ops.attention", "fused_attention_packed"),
            ("shapley_vit_tpu_torch.ops.attention", "fused_attention"),
            ("shapley_vit_tpu_torch.ops.mlp_block", "fused_mlp_block"))

# the fragments of the port's kernel names that the trace groups by family
KERNEL_FAMILIES = ("patch_embed", "attention", "mlp_block")

# the tiny sizes of the CPU tests
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            patch_size=4, image_size=16, validation_images=48)


def spec(config: dict, **overrides):
    """The program's ``ViTSpec`` at the configuration's widths and numerics."""
    from shapley_vit_tpu_torch.models import vit as tvit

    kw = dict(hidden=config["hidden_size"], depth=config["num_hidden_layers"],
              heads=config["num_attention_heads"], mlp_dim=config["intermediate_size"],
              patch=config["patch_size"], image=config["image_size"],
              channels=config["num_channels"], num_classes=config["num_labels"],
              layernorm_eps=config["layer_norm_eps"], lora_r=config["lora_r"],
              lora_alpha=float(config["lora_alpha"]), dtype=config["compute_dtype"],
              gelu=config["gelu"])
    kw.update(overrides)
    return tvit.ViTSpec(**kw)


def forward(spec):
    """The program's forward of one model, ``(base, overlay, images) ->
    logits``, as the client's training step differentiates it."""
    from shapley_vit_tpu_torch.models import vit as tvit

    def fwd(base, overlay, images):
        return tvit.vit_forward(base, overlay, images, spec)

    return fwd


def dims(cfg: dict) -> dict:
    """The sizes the shared inputs and counts read: width D, depth L, MLP
    width M, patch P, patches NP, tokens N (with CLS), channels C, classes
    K, LoRA rank r, image side, and ``head_in``, the classifier's input
    width."""
    P = cfg["patch_size"]
    NP = (cfg["image_size"] // P) ** 2
    return dict(D=cfg["hidden_size"], L=cfg["num_hidden_layers"], M=cfg["intermediate_size"], P=P,
                NP=NP, N=NP + 1, C=cfg["num_channels"], K=cfg["num_labels"], r=cfg["lora_r"],
                image=cfg["image_size"], head_in=cfg["hidden_size"])


def base(cfg: dict, gen: torch.Generator, device) -> dict:
    """The frozen base tree, in three draws: every matrix, every bias, every
    LayerNorm parameter. The trees have the program's key names and layouts
    (encoder leaves stacked on a leading depth axis, kernels ``[in, out]``)."""
    d = dims(cfg)
    D, L, M, P, C, K, N = d["D"], d["L"], d["M"], d["P"], d["C"], d["K"], d["N"]
    mats = {"patch": (P * P * C, D), "cls": (1, 1, D), "pos": (1, N, D),
            "q": (L, D, D), "k": (L, D, D), "v": (L, D, D), "out": (L, D, D),
            "fc1": (L, D, M), "fc2": (L, M, D), "head": (d["head_in"], K)}
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


def kernel_calls(cfg: dict, sequences: int, itemsize: int) -> Dict[str, Tuple[float, float]]:
    """Each hand kernel family's ``(operations, bytes)`` of one call in one
    block over ``sequences`` images: the fused MLP over their tokens and the
    packed attention over their sequences."""
    d = dims(cfg)
    return {"mlp_block": counts.mlp_block_call(sequences * d["N"], d["D"], d["M"], itemsize),
            "attention": counts.attention_packed_call(sequences, d["N"], d["D"], itemsize)}


def patch_flops(cfg: dict, images: int) -> float:
    d = dims(cfg)
    return 2.0 * images * d["NP"] * d["P"] * d["P"] * d["C"] * d["D"]


def encoder_flops_per_image(cfg: dict) -> float:
    """Matrix-product operations of one image through the encoder blocks
    with merged q/v (no LoRA products): q, k, v, out, QK^T, PV, fc1, fc2."""
    d = dims(cfg)
    N, D, M = d["N"], d["D"], d["M"]
    per_layer = 4 * 2.0 * N * D * D + 2 * 2.0 * N * N * D + 2 * 2.0 * N * D * M
    return d["L"] * per_layer


def head_flops_per_image(cfg: dict) -> float:
    d = dims(cfg)
    return 2.0 * d["head_in"] * d["K"]


def coalition_eval_flops(cfg: dict, images: int, coalitions: int) -> float:
    """One evaluation call: the patch embedding once per image (it does not
    depend on the coalition), the encoder and the classifier once per image
    and coalition."""
    return patch_flops(cfg, images) + coalitions * images * (
        encoder_flops_per_image(cfg) + head_flops_per_image(cfg))


def train_step_flops(cfg: dict, batch: int) -> float:
    """One LoRA training step: the forward with the rank-r q and v paths,
    the input-gradient backward of every product the loss reaches (none into
    the images or the first block's input, which need no gradient), and the
    weight gradients of the trainable leaves only (LoRA A and B, the
    classifier)."""
    d = dims(cfg)
    N, D, M, r, L, K = d["N"], d["D"], d["M"], d["r"], d["L"], d["K"]
    dense = 4 * 2.0 * N * D * D + 2 * 2.0 * N * D * M
    lora = 2 * (2.0 * N * D * r + 2.0 * N * r * D)
    attn = 2 * 2.0 * N * N * D
    forward = patch_flops(cfg, 1) + L * (dense + lora + attn) + 2.0 * D * K
    # input gradients: each product's other operand times the output
    # gradient; attention's backward is four N x N x D products
    back_layer = dense + lora + 2 * attn
    # block 0: no gradient into its LN1 output through q, k, v or the
    # LoRA A products, and none into its k (nothing trainable feeds it)
    skip0 = 3 * 2.0 * N * D * D + 2 * 2.0 * N * D * r + 2.0 * N * N * D
    weight_grads = L * 2 * (2.0 * N * D * r + 2.0 * N * r * D) + 2.0 * D * K
    backward = L * back_layer - skip0 + 2.0 * D * K + weight_grads
    return batch * (forward + backward)
