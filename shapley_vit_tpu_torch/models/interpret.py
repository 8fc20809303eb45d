"""Model interpretability: attention rollout and Grad-CAM for the ViT.

The port of ``shapley_vit_tpu/models/interpret.py``:

  * :func:`attention_rollout`: Abnar & Zuidema-style rollout: fuse the
    attention over heads, add identity (residual), row-normalize, and
    cumulatively matmul through the layers; the CLS row gives a patch
    saliency map.
  * :func:`grad_cam`: gradient of the target-class logit w.r.t. the token
    activations entering the final LN, token-weighted by the gradient (ViT
    analogue of CAM over the last feature map).

Both run a side-channel forward that collects per-layer attention
probabilities, which no fused kernel returns, so the encoder here is plain
torch ops, as JAX's is plain XLA. Its math is JAX's, step by step, whatever
the spec's kernel knobs say: exact-erf GELU and plain dense layers (no
int8, no fused MLP), weights cast to the compute dtype at each use, the
attention logits divided by √d in the compute dtype and the softmax in
float32, LoRA as ``(x·A)·B·scaling``. Its logits equal ``vit_forward``'s
only at ``gelu="exact_f32"`` with no quantization. The patch tokens come
from ``models.vit._embed``, the patch-embedding kernel, which at float32
computes JAX's ``_patchify(x) @ W + b``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.models.vit import ViTSpec, _embed, _layer_norm
from shapley_vit_tpu_torch.ops.tree_math import graph_ready, tree_map

Tree = object


def _attention_with_probs(x, attn_p, lora_p, spec: ViTSpec):
    """Same math as JAX models/vit._attention over ``x [B, N, D]``, also
    returning the softmax probabilities ``[B, H, N, N]`` (float32)."""
    B, N, D = x.shape
    h, hd = spec.heads, spec.head_dim
    scaling = spec.lora_alpha / spec.lora_r

    def proj(p, name):
        y = torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)
        if lora_p is not None and name in lora_p:
            a = lora_p[name]["A"].to(x.dtype)
            b = lora_p[name]["B"].to(x.dtype)
            y = y + torch.matmul(torch.matmul(x, a), b) * torch.tensor(scaling, dtype=x.dtype,
                                                                        device=x.device)
        return y.reshape(B, N, h, hd).transpose(1, 2)

    q, k, v = proj(attn_p["q"], "q"), proj(attn_p["k"], "k"), proj(attn_p["v"], "v")
    # divided by a tensor: a CUDA tensor's division by a Python number is a
    # product with the reciprocal, one ulp off
    logits = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(
        math.sqrt(hd), dtype=torch.float32, device=x.device).to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    ctx = torch.matmul(probs.to(x.dtype), v).transpose(1, 2).reshape(B, N, D)
    out = torch.matmul(ctx, attn_p["out"]["kernel"].to(x.dtype)) + attn_p["out"]["bias"].to(x.dtype)
    return out, probs


def _head(base, lora):
    return lora["classifier"] if lora is not None else base["classifier"]


def _logits(tokens, base, lora, spec: ViTSpec):
    """The final LN and the classifier on the CLS token, float32 logits."""
    normed = _layer_norm(tokens, base["final_ln"]["scale"], base["final_ln"]["bias"],
                         spec.layernorm_eps)
    head = _head(base, lora)
    dt = tokens.dtype
    return (torch.matmul(normed[:, 0], head["kernel"].to(dt)) + head["bias"].to(dt)).float()


def _forward_collect(base: Tree, lora: Optional[Tree], images, spec: ViTSpec):
    """Forward returning (logits, per-layer attention [L,B,H,N,N], tokens
    entering final LN [B,N,D])."""
    x = _embed(base, images, spec)
    blocks = base["blocks"]
    all_probs = []
    for layer in range(spec.depth):
        blk = tree_map(lambda a: a[layer], blocks)
        lora_p = tree_map(lambda a: a[layer], lora["lora"]) if lora is not None else None
        y = _layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"], spec.layernorm_eps)
        attn_out, probs = _attention_with_probs(y, blk["attn"], lora_p, spec)
        all_probs.append(probs)
        x = x + attn_out
        y = _layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"], spec.layernorm_eps)
        mlp = blk["mlp"]
        y = torch.matmul(y, mlp["fc1"]["kernel"].to(x.dtype)) + mlp["fc1"]["bias"].to(x.dtype)
        y = F.gelu(y.float()).to(x.dtype)
        y = torch.matmul(y, mlp["fc2"]["kernel"].to(x.dtype)) + mlp["fc2"]["bias"].to(x.dtype)
        x = x + y
    return _logits(x, base, lora, spec), torch.stack(all_probs), x


def _unit_range(sal: torch.Tensor) -> torch.Tensor:
    """Per-image min-max normalization of ``[B, g, g]`` maps to [0, 1]."""
    sal = sal - sal.amin(dim=(1, 2), keepdim=True)
    denom = sal.amax(dim=(1, 2), keepdim=True)
    return sal / torch.where(denom == 0, torch.ones_like(denom), denom)


def attention_rollout(
    base: Tree, lora: Optional[Tree], images, spec: ViTSpec,
    head_fuse: str = "mean",
) -> torch.Tensor:
    """Attention rollout -> patch saliency [B, grid, grid] in [0, 1]."""
    if head_fuse not in ("mean", "max"):
        raise ValueError(f"unknown head_fuse {head_fuse!r}")
    with torch.no_grad():
        _, probs, _ = _forward_collect(base, lora, images, spec)  # [L,B,H,N,N]
        A = probs.mean(dim=2) if head_fuse == "mean" else probs.amax(dim=2)
        L, B, N, _ = A.shape
        eye = torch.eye(N, device=A.device)[None]
        A = 0.5 * A + 0.5 * eye                    # residual mixing
        A = A / A.sum(dim=-1, keepdim=True)
        rollout = eye.expand(B, N, N)
        for a in A:
            rollout = torch.matmul(a, rollout)
        g = spec.image // spec.patch
        return _unit_range(rollout[:, 0, 1:].reshape(B, g, g))


def grad_cam(
    base: Tree, lora: Optional[Tree], images, spec: ViTSpec,
    class_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ViT Grad-CAM -> patch saliency [B, grid, grid]: ReLU(Σ_d ∂y_c/∂A_d ·
    A_d) over the final token activations. The collecting forward records no
    graph; only the final LN and the head are differentiated, from the
    tokens, as in JAX. Runs outside inference mode (its tensors must enter a
    graph), cloning parameters that were made in inference mode."""
    with torch.inference_mode(False):
        with torch.no_grad():
            _, _, t = _forward_collect(base, lora, images, spec)
        top = {"final_ln": tree_map(graph_ready, base["final_ln"]),
               "classifier": tree_map(graph_ready, _head(base, lora))}
        t = t.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = _logits(t, top, None, spec)
            idx = (logits.argmax(dim=-1) if class_idx is None
                   else torch.as_tensor(class_idx, device=logits.device).long())
            (g,) = torch.autograd.grad(logits.gather(-1, idx[:, None]).sum(), t)
        t = t.detach()
    weights = g.mean(dim=1, keepdim=True)           # channel importance
    cam = F.relu((weights * t).sum(dim=-1))[:, 1:]  # drop CLS
    gsz = spec.image // spec.patch
    return _unit_range(cam.reshape(cam.shape[0], gsz, gsz))
