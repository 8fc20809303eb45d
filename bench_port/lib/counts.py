"""The yardstick's arithmetic: published peaks, and the operations and bytes
of the ViT's work computed from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity). The
fused MLP's and the packed attention's operations and bytes are those of the
port's kernel table (``chip_smoke.py``, ``phase_kernels``): two operations
per multiply-add; each input byte read once and each output byte written
once.
"""

from __future__ import annotations

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12, "bytes": 3.35e12}


def bound_seconds(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of the operations over
    the dtype's peak and the bytes over the memory rate."""
    return max(flops / PEAKS[dtype], nbytes / PEAKS["bytes"])


def mlp_block_call(tokens: int, hidden: int, mlp_dim: int, itemsize: int = 2):
    """(operations, bytes) of one fused MLP block call over ``tokens`` rows:
    LN, fc1, GELU, fc2 and the residual."""
    flops = 4.0 * tokens * hidden * mlp_dim
    nbytes = (2 * tokens * hidden + 2 * hidden * mlp_dim + mlp_dim + 3 * hidden) * itemsize
    return flops, nbytes


def attention_packed_call(sequences: int, seq_len: int, hidden: int, itemsize: int = 2):
    """(operations, bytes) of one packed attention call over ``sequences``
    sequences of ``seq_len`` tokens and ``hidden`` columns (all heads):
    QK^T and PV; q, k, v read and the context written."""
    flops = 4.0 * sequences * seq_len * seq_len * hidden
    nbytes = 4.0 * sequences * seq_len * hidden * itemsize
    return flops, nbytes


def _dims(cfg: dict):
    D = cfg["hidden_size"]
    P = cfg["patch_size"]
    NP = (cfg["image_size"] // P) ** 2
    return dict(D=D, L=cfg["num_hidden_layers"], M=cfg["intermediate_size"], P=P, NP=NP, N=NP + 1,
                C=cfg["num_channels"], K=cfg["num_labels"], r=cfg["lora_r"])


def patch_flops(cfg: dict, images: int) -> float:
    d = _dims(cfg)
    return 2.0 * images * d["NP"] * d["P"] * d["P"] * d["C"] * d["D"]


def encoder_flops_per_image(cfg: dict) -> float:
    """Matrix-product operations of one image through the encoder blocks
    with merged q/v (no LoRA products): q, k, v, out, QK^T, PV, fc1, fc2."""
    d = _dims(cfg)
    N, D, M = d["N"], d["D"], d["M"]
    per_layer = 4 * 2.0 * N * D * D + 2 * 2.0 * N * N * D + 2 * 2.0 * N * D * M
    return d["L"] * per_layer


def head_flops_per_image(cfg: dict) -> float:
    d = _dims(cfg)
    return 2.0 * d["D"] * d["K"]


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
    d = _dims(cfg)
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
