"""Functional ViT with a LoRA overlay — the live-path model.

The port of ``shapley_vit_tpu/models/vit.py``: HF ``ViTForImageClassification``
semantics (pre-LN encoder, erf-GELU, learned position embeddings incl. CLS,
classifier on the CLS token) over plain parameter trees. Parameters are
nested dicts of tensors with the JAX tree's key names and layouts
(encoder-block leaves stacked on a leading depth axis ``[L, ...]``), so
weights carry over between the packages as numpy (``models.convert``).

What changed in the port:

* ``lax.scan`` over the stacked blocks is a Python loop over ``L``.
* The coalition ``vmap`` is a batch axis written out: activations are
  ``[C, B, N, D]``. The shared weights (k, out, fc1, fc2, LN, patch) see the
  coalition axis folded into the rows; the per-coalition q/v kernels (merged
  mode), LoRA factors (overlay mode) and classifier are batched products
  over ``[C, ...]``. The patch embedding and the CLS/position add do not
  depend on the coalition: they run once per batch and are expanded over C.
* The JAX spec's kernel knobs keep their names and pick between the port's
  kernels and differentiable torch ops. ``attention_impl``: ``"pallas2"``
  (the default here, the Shapley round's path) runs the packed kernel
  ``fused_attention_packed``, forward only; ``"pallas"`` splits the heads
  and runs ``fused_attention`` on ``[B, H, N, d]``, which has a gradient.
  ``mlp_impl``: ``"pallas"`` (the default here) runs the fused block
  ``fused_mlp_block``, forward only; ``"xla"`` runs the MLP half as torch
  ops (the JAX default path, vit.py:353-362). LoRA training uses
  ``spec.replace(attention_impl="pallas", mlp_impl="xla")``; the forward-only
  kernels raise when autograd would need their gradient. The patch
  embedding runs ``patch_embed`` (except under int8 with ``"patch"`` in
  the targets, below), whose backward (torch ops) gives the adversarial
  attacks their image gradient.
  The kernels' numerics follow the Pallas kernels (f32 softmax and
  accumulation in attention; LN -> fc1 -> GELU in f32 in the MLP, ``h``
  cast to the weight dtype before fc2, the residual added in f32), so at
  float32 the port matches either JAX path and at bfloat16 it is held
  against its own plain versions.
* ``remat`` checkpoints each block with ``torch.utils.checkpoint`` (the
  JAX ``jax.checkpoint`` of ``_block``): the backward recomputes a block's
  intermediates instead of keeping them.
* ``quant="int8"`` (dynamic W8A8, ``ops/quant.py``) quantizes the dense
  projections named in ``quant_targets`` (``INT8_TARGETS`` in the drivers),
  with the JAX package's rules: the rank-r LoRA path, the attention core and
  the classifier stay in the compute dtype; the fused MLP kernel
  (``mlp_impl="pallas"``) bypasses int8 on fc1 and fc2, as the JAX Pallas
  MLP does (vit.py:64-65), so only ``mlp_impl="xla"`` quantizes them; the
  merged q/v kernels quantize per coalition from the kernel already cast to
  the compute dtype, the shared kernels from their float32 base. With
  ``"patch"`` in ``quant_targets`` the patch projection is ``patchify`` and
  an int8 dense product (the JAX default ``patch_impl="xla"`` path,
  vit.py:396-397); otherwise it is the ``patch_embed`` kernel, which never
  quantizes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from shapley_vit_tpu_torch.ops.attention import fused_attention, fused_attention_packed
from shapley_vit_tpu_torch.ops.mlp_block import fused_mlp_block
from shapley_vit_tpu_torch.ops.patch_embed import patch_embed, patchify
from shapley_vit_tpu_torch.ops.quant import dynamic_int8_dense
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves, tree_map

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ATTENTION_IMPLS = ("pallas2", "pallas")
_MLP_IMPLS = ("pallas", "xla")
_QUANTS = ("none", "int8")


@dataclass(frozen=True)
class ViTSpec:
    """Architecture hyperparameters (HF ViTConfig equivalents).

    ``attention_impl`` and ``mlp_impl`` keep the JAX spec's names and values,
    so one spec reads the same in either package, and they stay explicit
    rather than inferred from whether autograd records the forward: the two
    paths round differently in bfloat16 (the fused MLP adds the residual in
    float32, the torch-op MLP in the compute dtype), and a model's logits
    should not depend on ``requires_grad``. A training forward through a
    forward-only kernel raises, so a forgotten
    ``replace(attention_impl="pallas", mlp_impl="xla")`` is an error, not a
    wrong gradient."""

    hidden: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    patch: int = 16
    image: int = 224
    channels: int = 3
    num_classes: int = 4
    layernorm_eps: float = 1e-12   # HF ViTConfig default
    # LoRA (reference start.py:274-276)
    lora_r: int = 16
    lora_alpha: float = 8.0
    # activation/compute dtype: float32 | bfloat16
    dtype: str = "float32"
    # GELU flavor: 'exact_f32' (HF parity: erf in f32), 'exact' (erf in the
    # compute dtype), 'tanh' (tanh approximation in the compute dtype). The
    # fused MLP kernel computes GELU in float32 either way, so there 'exact'
    # and 'exact_f32' are the same function (as under the JAX MLP kernel)
    gelu: str = "exact_f32"
    # attention: 'pallas2' (packed kernel, forward only) or 'pallas'
    # ([B, H, N, d] kernel with a gradient)
    attention_impl: str = "pallas2"
    # MLP half: 'pallas' (fused kernel, forward only) or 'xla' (torch ops)
    mlp_impl: str = "pallas"
    # matmul quantization: 'none' | 'int8' (dynamic W8A8 on the dense
    # projections named in quant_targets; ops/quant.py)
    quant: str = "none"
    # which dense matmuls quantize under quant='int8' (the JAX default; the
    # drivers pass INT8_TARGETS)
    quant_targets: tuple = ("patch", "q", "k", "v", "out", "fc1", "fc2")
    # recompute each block's intermediates on the backward pass (the client
    # sets it from cfg.train.remat)
    remat: bool = False

    def __post_init__(self):
        for name, allowed in (("attention_impl", _ATTENTION_IMPLS), ("mlp_impl", _MLP_IMPLS),
                              ("quant", _QUANTS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")

    @property
    def num_patches(self) -> int:
        return (self.image // self.patch) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ViTSpec":
        return dataclasses.replace(self, **kw)


VIT_VARIANTS = {
    "tiny": dict(hidden=192, depth=12, heads=3, mlp_dim=768),
    "small": dict(hidden=384, depth=12, heads=6, mlp_dim=1536),
    "base": dict(hidden=768, depth=12, heads=12, mlp_dim=3072),
    "large": dict(hidden=1024, depth=24, heads=16, mlp_dim=4096),
    # micro: CI-sized fixture for fast tests
    "micro": dict(hidden=32, depth=2, heads=2, mlp_dim=64, patch=4, image=16),
}


# the int8 target set the drivers use (JAX vit.py:125): q/k/v/fc1 only
INT8_TARGETS = ("q", "k", "v", "fc1")


def make_spec(variant: str = "base", **overrides) -> ViTSpec:
    if overrides.get("dtype", "float32") not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {overrides['dtype']!r}")
    return ViTSpec(**{**VIT_VARIANTS[variant], **overrides})


# ---------------------------------------------------------------------------
# Init (same distributions as the JAX package; the tests carry weights over)
# ---------------------------------------------------------------------------

def _trunc_normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=gen)
    return t


def init_vit(gen: torch.Generator, spec: ViTSpec, device="cpu") -> Tree:
    """The frozen base tree, drawn on the CPU from ``gen`` and moved to
    ``device``. Encoder-block leaves carry a leading depth axis [L, ...]."""
    D, L, M = spec.hidden, spec.depth, spec.mlp_dim
    P, C = spec.patch, spec.channels

    def dense(din, dout, layers=None):
        shape = (din, dout) if layers is None else (layers, din, dout)
        bshape = (dout,) if layers is None else (layers, dout)
        return {"kernel": _trunc_normal(gen, shape), "bias": torch.zeros(bshape)}

    tree = {
        "patch_embed": dense(P * P * C, D),
        "cls_token": _trunc_normal(gen, (1, 1, D)),
        "pos_embed": _trunc_normal(gen, (1, spec.seq_len, D)),
        "blocks": {
            "ln1": {"scale": torch.ones((L, D)), "bias": torch.zeros((L, D))},
            "attn": {
                "q": dense(D, D, L),
                "k": dense(D, D, L),
                "v": dense(D, D, L),
                "out": dense(D, D, L),
            },
            "ln2": {"scale": torch.ones((L, D)), "bias": torch.zeros((L, D))},
            "mlp": {"fc1": dense(D, M, L), "fc2": dense(M, D, L)},
        },
        "final_ln": {"scale": torch.ones((D,)), "bias": torch.zeros((D,))},
        "classifier": dense(D, spec.num_classes),
    }
    return tree_map(lambda x: x.to(device), tree)


def init_lora(gen: torch.Generator, spec: ViTSpec, classifier_from: Optional[Tree] = None,
              device="cpu") -> Tree:
    """The trainable overlay: LoRA A/B for q,v in every block plus the
    classifier head (peft ``modules_to_save=['classifier']``). peft init:
    A ~ kaiming-uniform with bound sqrt(1/fan_in), B = 0. Layout is
    x @ A @ B with A:[D,r], B:[r,D]."""
    D, L, r = spec.hidden, spec.depth, spec.lora_r
    bound = (1.0 / D) ** 0.5

    def kaiming_uniform(shape):
        return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)

    lora = {
        "q": {"A": kaiming_uniform((L, D, r)), "B": torch.zeros((L, r, D))},
        "v": {"A": kaiming_uniform((L, D, r)), "B": torch.zeros((L, r, D))},
    }
    if classifier_from is not None:
        classifier = tree_map(lambda x: x.detach().clone().cpu(), classifier_from["classifier"])
    else:
        classifier = {
            "kernel": torch.zeros((D, spec.num_classes)),
            "bias": torch.zeros((spec.num_classes,)),
        }
    return tree_map(lambda x: x.to(device), {"lora": lora, "classifier": classifier})


def trainable_params(lora_tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(lora_tree))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_norm(x, scale, bias, eps):
    # f32 statistics regardless of compute dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _dense(x, kernel, bias, spec: Optional[ViTSpec] = None, name: str = ""):
    """``x [C, T, Din]`` times a shared ``[Din, Dout]`` kernel (the coalition
    axis folds into the rows) or a per-coalition ``[C, Din, Dout]`` kernel
    (a batched product), in the compute dtype, or in dynamic int8 under
    ``spec.quant == "int8"`` when ``name`` is in ``spec.quant_targets``."""
    if spec is not None and spec.quant == "int8" and name in spec.quant_targets:
        return dynamic_int8_dense(x, kernel, bias, out_dtype=x.dtype)
    if bias.dim() == 2:  # per-coalition bias [C, Dout]
        bias = bias[:, None, :]
    return torch.matmul(x, kernel.to(x.dtype)) + bias.to(x.dtype)


def _patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B,H,W,C] -> [B, N, patch*patch*C] with HF (ph, pw, C) ordering."""
    return patchify(images, patch)


def _attention(x, attn_p, lora_p, spec: ViTSpec, q_kernel=None, v_kernel=None):
    """Multi-head self-attention over ``x [C, B, N, D]``.

    q and v use the per-coalition merged kernels when given (merged mode),
    else the shared kernels plus the LoRA path
    ``scaling·(x·A_c)·B_c`` in the compute dtype (overlay mode; peft's
    forward, never materializing the [D, D] delta)."""
    C, B, N, D = x.shape
    xt = x.reshape(C, B * N, D)
    scaling = spec.lora_alpha / spec.lora_r

    def proj(name, merged_kernel):
        p = attn_p[name]
        y = _dense(xt, p["kernel"] if merged_kernel is None else merged_kernel, p["bias"],
                   spec, name)
        if lora_p is not None and name in lora_p:
            # the rank-r path stays in the compute dtype under int8
            a = lora_p[name]["A"].to(x.dtype)
            b = lora_p[name]["B"].to(x.dtype)
            y = y + torch.matmul(torch.matmul(xt, a), b) * scaling
        return y.reshape(C * B, N, D)

    q = proj("q", q_kernel)
    k = proj("k", None)
    v = proj("v", v_kernel)
    if spec.attention_impl == "pallas2":
        ctx = fused_attention_packed(q, k, v, heads=spec.heads)
    else:
        def split_heads(y):  # [C·B, N, D] -> [C·B, H, N, d], a view
            return y.reshape(C * B, N, spec.heads, spec.head_dim).transpose(1, 2)

        ctx = fused_attention(split_heads(q), split_heads(k), split_heads(v)).transpose(1, 2)
    ctx = ctx.reshape(C, B * N, D)
    out = _dense(ctx, attn_p["out"]["kernel"], attn_p["out"]["bias"], spec, "out")
    return out.reshape(C, B, N, D)


def mlp_half_xla(x, blk_p, spec: ViTSpec):
    """The MLP half of a block as torch ops (``mlp_impl="xla"``, JAX
    vit.py:353-362): ``x + fc2(GELU(fc1(LN2(x))))`` in the compute dtype,
    over ``x [..., D]``; ``blk_p`` holds ``ln2`` and ``mlp``."""
    mlp = blk_p["mlp"]
    y = _layer_norm(x, blk_p["ln2"]["scale"], blk_p["ln2"]["bias"], spec.layernorm_eps)
    y = _dense(y, mlp["fc1"]["kernel"], mlp["fc1"]["bias"], spec, "fc1")
    if spec.gelu == "exact_f32":  # HF parity: erf GELU in f32
        y = F.gelu(y.float()).to(x.dtype)
    else:
        y = F.gelu(y, approximate="tanh" if spec.gelu == "tanh" else "none")
    return x + _dense(y, mlp["fc2"]["kernel"], mlp["fc2"]["bias"], spec, "fc2")


def _block(x, blk_p, lora_p, spec: ViTSpec, q_kernel=None, v_kernel=None):
    """Pre-LN transformer block (HF ViTLayer) over ``x [C, B, N, D]``."""
    eps = spec.layernorm_eps
    y = _layer_norm(x, blk_p["ln1"]["scale"], blk_p["ln1"]["bias"], eps)
    x = x + _attention(y, blk_p["attn"], lora_p, spec, q_kernel, v_kernel)
    if spec.mlp_impl == "xla":
        return mlp_half_xla(x, blk_p, spec)
    # the fused kernel bypasses int8 on fc1 and fc2, as the JAX Pallas MLP does
    mlp = blk_p["mlp"]
    # the fused block, with the LN and fc weights cast to the compute dtype
    # first (the JAX wiring, vit.py:338-346)
    dt = x.dtype
    out = fused_mlp_block(
        x.reshape(-1, x.shape[-1]),
        blk_p["ln2"]["scale"].to(dt),
        blk_p["ln2"]["bias"].to(dt),
        mlp["fc1"]["kernel"].to(dt),
        mlp["fc1"]["bias"].to(dt),
        mlp["fc2"]["kernel"].to(dt),
        mlp["fc2"]["bias"].to(dt),
        eps=eps,
        approximate_gelu=spec.gelu == "tanh",
    )
    return out.reshape(x.shape)


def _embed(base, images, spec: ViTSpec):
    """Patch tokens + CLS + positions, ``[B, N, D]`` in the compute dtype."""
    dt = spec.compute_dtype
    kernel, bias = base["patch_embed"]["kernel"], base["patch_embed"]["bias"]
    if spec.quant == "int8" and "patch" in spec.quant_targets:
        x = _dense(_patchify(images.to(dt), spec.patch), kernel, bias, spec, "patch")
    else:
        x = patch_embed(images.to(dt), kernel.to(dt), bias.to(dt), spec.patch)
    B = x.shape[0]
    cls = base["cls_token"].to(dt).expand(B, 1, spec.hidden)
    x = torch.cat([cls, x], dim=1)
    return x + base["pos_embed"].to(dt)


def _forward(base, images, spec: ViTSpec, C: int, lora_blocks=None, q_kernel=None,
             v_kernel=None, head=None):
    """The encoder over C coalitions at once -> logits [C, B, num_classes]
    (float32). Per-coalition leaves carry a leading C axis: ``lora_blocks``
    [C, L, ...], ``q_kernel``/``v_kernel`` [C, L, D, D], ``head`` kernel
    [C, D, K] and bias [C, K]; ``head=None`` uses the base classifier."""
    x0 = _embed(base, images, spec)
    x = x0.unsqueeze(0).expand(C, *x0.shape)
    blocks = base["blocks"]
    block = _block
    if spec.remat and torch.is_grad_enabled():
        def block(*args):
            return checkpoint(_block, *args, use_reentrant=False)
    for layer in range(spec.depth):
        blk = tree_map(lambda a: a[layer], blocks)
        lora_l = (
            tree_map(lambda a: a[:, layer], lora_blocks) if lora_blocks is not None else None
        )
        x = block(
            x, blk, lora_l, spec,
            q_kernel[:, layer] if q_kernel is not None else None,
            v_kernel[:, layer] if v_kernel is not None else None,
        )
    x = _layer_norm(x, base["final_ln"]["scale"], base["final_ln"]["bias"], spec.layernorm_eps)
    cls_repr = x[:, :, 0]  # [C, B, D]
    head = head if head is not None else base["classifier"]
    return _dense(cls_repr, head["kernel"], head["bias"]).float()


def vit_forward(base: Tree, lora: Optional[Tree], images: torch.Tensor, spec: ViTSpec) -> torch.Tensor:
    """ViT forward pass of ONE model -> logits [B, num_classes] (float32).
    ``lora=None`` runs the plain base model; otherwise the LoRA q/v overlay
    and the overlay's classifier head are applied (peft ``modules_to_save``
    replaces the head)."""
    if lora is None:
        return _forward(base, images, spec, 1)[0]
    stacked = tree_map(lambda a: a[None], lora)
    return vit_forward_coalitions(base, stacked, images, spec)[0]


def vit_forward_coalitions(base: Tree, stacked_lora: Tree, images: torch.Tensor,
                           spec: ViTSpec) -> torch.Tensor:
    """Overlay-mode forward of C stacked LoRA overlays (leaves ``[C, ...]``)
    -> logits [C, B, num_classes]: the JAX package's ``vmap`` of
    ``vit_forward`` over the coalition axis."""
    C = stacked_lora["classifier"]["kernel"].shape[0]
    return _forward(base, images, spec, C, lora_blocks=stacked_lora["lora"],
                    head=stacked_lora["classifier"])


def merge_coalition_weights(base: Tree, stacked_lora: Tree, spec: ViTSpec) -> Tree:
    """Fold C stacked LoRA overlays into full per-coalition q/v kernels,
    W_eff[c] = W + scale·A_c@B_c, contracted in float32 (TF32 off) and cast
    to the compute dtype. Returns ``{"q_kernel": [C,L,D,D], "v_kernel":
    [C,L,D,D], "classifier": {...[C,...]}}``."""
    scaling = spec.lora_alpha / spec.lora_r

    def fold(name):
        delta = torch.einsum(
            "cldr,clre->clde",
            stacked_lora["lora"][name]["A"].float(),
            stacked_lora["lora"][name]["B"].float(),
        ) * scaling
        kern = base["blocks"]["attn"][name]["kernel"]
        return (kern[None] + delta).to(spec.compute_dtype)

    return {
        "q_kernel": fold("q"),
        "v_kernel": fold("v"),
        "classifier": dict(stacked_lora["classifier"]),
    }


def vit_forward_merged(base: Tree, merged: Tree, images: torch.Tensor, spec: ViTSpec) -> torch.Tensor:
    """Forward of every coalition of a merged tree (leading C axis on each
    leaf of ``merged``) -> logits [C, B, num_classes]: the base model with
    the q/v kernels and the classifier overridden per coalition. The same
    math as ``vit_forward_coalitions`` with the overlay folded in."""
    C = merged["q_kernel"].shape[0]
    return _forward(base, images, spec, C, q_kernel=merged["q_kernel"],
                    v_kernel=merged["v_kernel"], head=merged["classifier"])


def merge_lora(base: Tree, lora: Tree, spec: ViTSpec) -> Tree:
    """Fold the LoRA overlay into a standalone base tree (peft
    ``merge_and_unload``): Wq += scaling·A@B, Wv likewise, head replaced."""
    scaling = spec.lora_alpha / spec.lora_r
    attn = dict(base["blocks"]["attn"])
    for name in ("q", "v"):
        delta = torch.einsum(
            "ldr,lre->lde", lora["lora"][name]["A"].float(), lora["lora"][name]["B"].float()
        ) * scaling
        attn[name] = {"kernel": attn[name]["kernel"] + delta, "bias": attn[name]["bias"]}
    blocks = dict(base["blocks"])
    blocks["attn"] = attn
    merged = dict(base)
    merged["blocks"] = blocks
    merged["classifier"] = tree_map(lambda x: x.clone(), lora["classifier"])
    return merged
