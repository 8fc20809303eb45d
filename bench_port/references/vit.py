"""The plain reference of the ViT configurations: HF ``ViTForImageClassification``
(pre-LN encoder, erf GELU, learned positions with CLS, classifier on the CLS
token) with a LoRA overlay on q and v, FedAvg of client deltas, the
validation utilities, the complementary-contribution Shapley scoring, and
the client's Adam step.

Plain PyTorch in float32 with TF32 off, in blocks of images so that it fits
beside the program. It imports nothing of the program, nor JAX: it reads
the weights, deltas and images that the benchmark made, and works out again
whatever the program derives from them (the coalitions' weight rows, the
FedAvg'd overlays, the folded q/v kernels, the losses and gradients).

``quant="fp8"`` makes the control of every cell: the inputs of every dense
product rounded to e4m3 (the activations per row, the kernels per output
column), the products' output gradients to e5m2; the rank-r LoRA paths,
attention and the classifier stay float32.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

DENSE = ("patch", "q", "k", "v", "out", "fc1", "fc2")
LEAVES = ("classifier.bias", "classifier.kernel", "lora.q.A", "lora.q.B", "lora.v.A", "lora.v.B")


class float32_exact:
    """Float32 products without TF32 inside the block; the caller's flags
    are restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
        return False


def leaf(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    # e4m3, with a scale that maps the absolute maximum along ``dim`` to 448
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2 per tensor (scaled so
    its absolute maximum maps to 57344), as fp8 training sends it back."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp_min(1e-30) / 57344.0
        return (g / scale).to(torch.float8_e5m2).float() * scale


def dense(x, kernel, bias, quant: Optional[str] = None, name: str = ""):
    """``x @ kernel + bias``; with ``quant="fp8"`` the product's inputs are
    rounded to e4m3 first and its output's gradient to e5m2."""
    if quant is not None and quant != "fp8":
        raise ValueError(f"quant {quant!r}: only 'fp8' is a control here")
    if quant and name in DENSE:
        y = _fake_fp8(x, -1) @ _fake_fp8(kernel, -2)
        if torch.is_grad_enabled():
            y = _GradE5M2.apply(y)
        return y + bias
    return x @ kernel + bias


def layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def forward(base, images, cfg: dict, q_kernel=None, v_kernel=None, lora=None, head=None,
            quant: Optional[str] = None) -> torch.Tensor:
    """Logits ``[B, K]`` of one model. q and v take ``q_kernel`` /
    ``v_kernel`` ``[L, D, D]`` when given (a folded overlay), else the base
    kernels plus, with ``lora``, the path ``(alpha / r) (x A) B``; ``head``
    replaces the base classifier."""
    B, H, W, C = images.shape
    P = cfg["patch_size"]
    D, L, heads = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    dh = D // heads
    scaling = cfg["lora_alpha"] / cfg["lora_r"]
    g = H // P
    patches = images.float().reshape(B, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, g * g, P * P * C)
    x = dense(patches, base["patch_embed"]["kernel"], base["patch_embed"]["bias"], quant, "patch")
    x = torch.cat([base["cls_token"].expand(B, 1, D), x], dim=1) + base["pos_embed"]
    N = x.shape[1]
    blk = base["blocks"]
    for i in range(L):
        y = layer_norm(x, blk["ln1"]["scale"][i], blk["ln1"]["bias"][i], eps)
        att = blk["attn"]

        def proj(name, kernel):
            out = dense(y, att[name]["kernel"][i] if kernel is None else kernel[i],
                        att[name]["bias"][i], quant, name)
            if lora is not None and name in lora["lora"]:
                out = out + (y @ lora["lora"][name]["A"][i]) @ lora["lora"][name]["B"][i] * scaling
            return out.reshape(B, N, heads, dh).transpose(1, 2)

        q, k, v = proj("q", q_kernel), proj("k", None), proj("v", v_kernel)
        p = torch.softmax((q @ k.transpose(-1, -2)) / dh ** 0.5, dim=-1)
        ctx = (p @ v).transpose(1, 2).reshape(B, N, D)
        x = x + dense(ctx, att["out"]["kernel"][i], att["out"]["bias"][i], quant, "out")
        y = layer_norm(x, blk["ln2"]["scale"][i], blk["ln2"]["bias"][i], eps)
        mlp = blk["mlp"]
        y = F.gelu(dense(y, mlp["fc1"]["kernel"][i], mlp["fc1"]["bias"][i], quant, "fc1"))
        x = x + dense(y, mlp["fc2"]["kernel"][i], mlp["fc2"]["bias"][i], quant, "fc2")
    x = layer_norm(x, base["final_ln"]["scale"], base["final_ln"]["bias"], eps)
    head = head if head is not None else base["classifier"]
    return x[:, 0] @ head["kernel"] + head["bias"]


# ---------------------------------------------------------------------------
# Coalitions: FedAvg of the members' deltas, folded into q and v
# ---------------------------------------------------------------------------

def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def weight_row(members: Sequence[int], sizes: Sequence[float], n: int) -> np.ndarray:
    """FedAvg ratios of a coalition's members by their data sizes (zero for
    the others)."""
    row = np.zeros(n, np.float64)
    total = float(sum(sizes[j] for j in members))
    for j in members:
        row[j] = sizes[j] / total
    return row


def mix_overlay(init: dict, deltas: List[dict], row: np.ndarray, device) -> dict:
    """``init + sum_j row[j] delta_j`` per leaf, in float32 on ``device``."""
    out = {}
    for path in LEAVES:
        acc = leaf(init, path).detach().float().clone()
        for j, w in enumerate(row):
            if w:
                acc += float(w) * torch.as_tensor(leaf(deltas[j], path), device=device, dtype=torch.float32)
        out[path] = acc
    return out


def fold(base, overlay: dict, cfg: dict):
    """Folded q and v kernels ``W + (alpha / r) A B`` of a mixed overlay."""
    scaling = cfg["lora_alpha"] / cfg["lora_r"]
    return {n: base["blocks"]["attn"][n]["kernel"] + scaling * (overlay[f"lora.{n}.A"] @ overlay[f"lora.{n}.B"])
            for n in ("q", "v")}


def utility(base, overlay: dict, images, labels, cfg: dict, block: int,
            quant: Optional[str] = None) -> np.ndarray:
    """(accuracy, mean cross-entropy) of one folded model over the images,
    in blocks of ``block``."""
    folded = fold(base, overlay, cfg)
    head = {"kernel": overlay["classifier.kernel"], "bias": overlay["classifier.bias"]}
    correct, loss = 0.0, 0.0
    for s in range(0, len(labels), block):
        x, y = images[s:s + block], labels[s:s + block].long()
        logits = forward(base, x, cfg, q_kernel=folded["q"], v_kernel=folded["v"], head=head,
                         quant=quant)
        correct += float((logits.argmax(dim=-1) == y).sum())
        loss += float(F.cross_entropy(logits.double(), y, reduction="sum"))
    n = len(labels)
    return np.array([correct / n, loss / n])


def coalition_utilities(base, init: dict, deltas: List[dict], sizes: Sequence[float],
                        images, labels, cfg: dict, block: int = 100,
                        quant: Optional[str] = None) -> Dict[frozenset, np.ndarray]:
    """Absolute (accuracy, loss) of every non-empty coalition of the
    clients, and of the initial overlay under ``frozenset()``."""
    n = len(deltas)
    device = images.device
    deltas = [{k: torch.as_tensor(leaf(d, k), device=device, dtype=torch.float32) for k in LEAVES}
              for d in deltas]
    deltas = [_nest(d) for d in deltas]
    out = {}
    with torch.no_grad(), float32_exact():
        out[frozenset()] = utility(base, mix_overlay(init, deltas, np.zeros(n), device),
                                   images, labels, cfg, block, quant)
        for r in range(1, n + 1):
            for members in itertools.combinations(range(n), r):
                ov = mix_overlay(init, deltas, weight_row(members, sizes, n), device)
                out[frozenset(members)] = utility(base, ov, images, labels, cfg, block, quant)
    return out


# ---------------------------------------------------------------------------
# Complementary-contribution Shapley values
# ---------------------------------------------------------------------------

def comp_contrib(n: int, m: int, absolute: Dict[frozenset, np.ndarray], rng: np.random.Generator):
    """The complementary-contribution estimate: m draws of a permutation and
    a split point j uniform on 1..n; u(S) - u(N minus S) credited to the
    members at stratum j and taken from the others at stratum n - j; the
    mean per stratum, summed over strata, over n. A utility is the absolute
    one minus the initial model's; the empty coalition's is zero.
    Returns ``[dims, n]``."""
    prev = absolute[frozenset()]
    dim = len(prev)

    def u(members):
        key = frozenset(int(i) for i in members)
        return np.zeros(dim) if not key else absolute[key] - prev

    total = np.zeros((dim, n + 1, n))
    count = np.zeros((n + 1, n))
    for _ in range(m):
        idxs = rng.permutation(n)
        j = int(rng.integers(1, n + 1))
        cc = u(idxs[:j]) - u(idxs[j:])
        for i in idxs[:j]:
            total[:, j, i] += cc
            count[j, i] += 1
        for i in idxs[j:]:
            total[:, n - j, i] -= cc
            count[n - j, i] += 1
    mean = np.where(count > 0, total / np.maximum(count, 1), 0.0)
    return mean.sum(axis=1) / n


# ---------------------------------------------------------------------------
# The client's LoRA step: cross-entropy, backward, Adam
# ---------------------------------------------------------------------------

def train_steps(base, init: dict, images, labels, batches: List[torch.Tensor], cfg: dict,
                lr: float, quant: Optional[str] = None, half_batch: bool = False,
                moving_rule: float = 1e-3):
    """Adam (betas 0.9, 0.999, eps 1e-8) on the overlay over ``batches`` (row
    indices). Returns ``(losses, first_grads, changes, moving)``: each
    step's loss, each leaf's gradient at step 1, each leaf's change after
    the last step, and the leaves whose gradient norm is at least
    ``moving_rule`` times the median leaf's at some step (the others move
    by round-off alone). ``half_batch`` leaves out the second half of each
    batch (a fault)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p0 = {k: leaf(init, k).detach().float().clone() for k in LEAVES}
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, first = [], None
    moving = set()
    with float32_exact():
        for t, idx in enumerate(batches, 1):
            if half_batch:
                idx = idx[: len(idx) // 2]
            x, y = images[idx], labels[idx].long()
            lora = {"lora": {n: {"A": params[f"lora.{n}.A"], "B": params[f"lora.{n}.B"]}
                             for n in ("q", "v")}}
            head = {"kernel": params["classifier.kernel"], "bias": params["classifier.bias"]}
            loss = F.cross_entropy(forward(base, x, cfg, lora=lora, head=head, quant=quant), y)
            grads = torch.autograd.grad(loss, [params[k] for k in LEAVES])
            losses.append(loss.item())
            norms = [float(g.norm()) for g in grads]
            median = float(np.median(norms))
            moving |= {k for k, nrm in zip(LEAVES, norms) if nrm >= moving_rule * median}
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(LEAVES, grads)}
            with torch.no_grad():
                for k, g in zip(LEAVES, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v2[k] / (1 - b2 ** t)
                    params[k] -= lr * mhat / (vhat.sqrt() + eps)
    changes = {k: (params[k].detach() - p0[k]) for k in LEAVES}
    return losses, first, changes, [k for k in LEAVES if k in moving]
