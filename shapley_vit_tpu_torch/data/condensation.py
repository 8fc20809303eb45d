"""Data-condensation suite: gradient-matching losses, differentiable
augmentation (DiffAugment), CPU augmentation, and the condensation train
loops (the port of ``shapley_vit_tpu/data/condensation.py``).

Reference: ``federated_learning/utils.py:1268-1878`` — ``TensorDataset`` /
``ServerSynDataset`` (1268-1304), gradient ``match_loss`` ours/mse/cos with
``distance_wb`` (1415-1460), ``epoch`` / ``epoch_data_weight`` train loops
with per-sample weights (1485-1572), CPU ``augment`` crop/scale/rotate/noise
(1574-1633), ``get_daparam`` (1641-1657), ``get_eval_pool`` (1660-1680), and
the DiffAugment family with Siamese seeding (1683-1859).

What the port keeps and changes:

* images are NHWC, as in the JAX package (the reference is NCHW);
* gradient trees are ``models.zoo`` state dicts' gradients in torch
  layouts: a convolution ``[O, I, kh, kw]`` and a linear ``[out, in]``
  group by their first axis, as does a 3-D LayerNorm leaf ``[C, h, w]``
  (the reference's grouping; the JAX zoo keeps LayerNorm as ``[H, W, C]``,
  so JAX's ``match_loss`` on a real ConvNetLN tree groups by H);
* each DiffAugment transform is a draw (``draw_<name>(generator, n,
  param)``, from a ``torch.Generator`` on its device) and a deterministic,
  differentiable transform of the draws (``<name>(x, *draws, param)``), so
  JAX's draws can be replayed; ``siamese=True`` draws for one sample and
  broadcasts it to the batch (JAX takes sample 0's draw of a whole batch),
  so two batches of any sizes get the same transform from equal seeds, as
  the reference's per-draw reseeding gives;
* ``affine_grid`` + ``grid_sample`` are torch's own (``align_corners=False``,
  bilinear, zero padding), which the JAX module reimplements;
* the train loops take ``models.zoo.get_network``'s ``apply_fn(variables,
  x)`` (no ``train=``: a BatchNorm network is normalised by its running
  statistics and they pass through unchanged, as in JAX) and
  ``fl.training``'s ``adam`` / ``sgd``; :func:`trainable_variables` and
  :func:`parameters` stand for JAX's ``variables["params"]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shapley_vit_tpu_torch.data.arrays import ArrayDataset
from shapley_vit_tpu_torch.fl.training import trainable
from shapley_vit_tpu_torch.ops.tree_math import tree_leaves


@dataclasses.dataclass
class SynDataset:
    """Server-side synthetic set with per-sample source-client ids
    (reference ServerSynDataset, utils.py:1286-1304)."""

    images: np.ndarray
    labels: np.ndarray
    src: np.ndarray

    def __len__(self):
        return len(self.labels)

    def as_array_dataset(self) -> ArrayDataset:
        return ArrayDataset(images=self.images, labels=self.labels)


# ---------------------------------------------------------------------------
# gradient matching (utils.py:1406-1460)
# ---------------------------------------------------------------------------

def distance_wb(gwr: torch.Tensor, gws: torch.Tensor) -> torch.Tensor:
    """Per-parameter grouped cosine distance (utils.py:1406-1426): a conv
    kernel ``[O, I, kh, kw]`` grouped by output channel, a linear ``[out,
    in]`` by row, a LayerNorm ``[C, h, w]`` by channel; a 1-D leaf (norm,
    bias) contributes 0."""
    if gwr.dim() <= 1:
        return gwr.new_zeros(())
    gwr = gwr.reshape(gwr.shape[0], -1)
    gws = gws.reshape(gws.shape[0], -1)
    cos = torch.sum(gwr * gws, dim=-1) / (
        torch.linalg.norm(gwr, dim=-1) * torch.linalg.norm(gws, dim=-1) + 1e-6)
    return torch.sum(1 - cos)


def match_loss(gw_syn, gw_real, dis_metric: str = "ours") -> torch.Tensor:
    """Gradient-matching distance over two gradient trees (state dicts of
    gradients, or sequences as ``torch.autograd.grad`` returns them;
    utils.py:1430-1460): 'ours' grouped cosine, 'mse' squared error over
    the flattened concat, 'cos' single cosine over the flattened concat."""
    syn_leaves, real_leaves = tree_leaves(gw_syn), tree_leaves(gw_real)
    if dis_metric == "ours":
        return sum(distance_wb(r, s) for r, s in zip(real_leaves, syn_leaves))
    real_vec = torch.cat([x.reshape(-1) for x in real_leaves])
    syn_vec = torch.cat([x.reshape(-1) for x in syn_leaves])
    if dis_metric == "mse":
        return torch.sum((syn_vec - real_vec) ** 2)
    if dis_metric == "cos":
        return 1 - torch.sum(real_vec * syn_vec) / (
            torch.linalg.norm(real_vec) * torch.linalg.norm(syn_vec) + 1e-6)
    raise ValueError(f"unknown distance function: {dis_metric}")


# ---------------------------------------------------------------------------
# DiffAugment (utils.py:1683-1859)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDiffAug:
    """(utils.py:1683-1694)."""

    aug_mode: str = "S"
    prob_flip: float = 0.5
    ratio_scale: float = 1.2
    ratio_rotate: float = 15.0
    ratio_crop_pad: float = 0.125
    ratio_cutout: float = 0.5
    brightness: float = 1.0
    saturation: float = 2.0
    contrast: float = 0.5


def _uniform(generator: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand((n,), generator=generator, device=generator.device)


def _randint(generator: torch.Generator, low: int, high: int, n: int) -> torch.Tensor:
    return torch.randint(low, high, (n,), generator=generator, device=generator.device)


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A draw of one value per sample (or one for all) as ``[B|1, 1, 1, 1]``
    on x's device and in its dtype."""
    return v.to(x.device, x.dtype).reshape(-1, 1, 1, 1)


def _affine_sample(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """torch's ``affine_grid`` + ``grid_sample`` (align_corners=False,
    bilinear, zero padding) on NHWC ``x``; ``theta`` ``[B, 2, 3]`` maps the
    output's normalized coordinates (u, v, 1) to the input's."""
    nchw = x.permute(0, 3, 1, 2)
    grid = F.affine_grid(theta.expand(x.shape[0], 2, 3), list(nchw.shape), align_corners=False)
    out = F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def draw_scale(generator, n: int, param: ParamDiffAug, hw=None):
    ratio = param.ratio_scale
    sx = _uniform(generator, n) * (ratio - 1.0 / ratio) + 1.0 / ratio
    sy = _uniform(generator, n) * (ratio - 1.0 / ratio) + 1.0 / ratio
    return sx, sy


def scale(x, sx, sy, param: Optional[ParamDiffAug] = None):
    """(utils.py:1734-1749)."""
    sx, sy = sx.to(x.device, x.dtype), sy.to(x.device, x.dtype)
    zeros = torch.zeros_like(sx)
    theta = torch.stack([torch.stack([sx, zeros, zeros], -1),
                         torch.stack([zeros, sy, zeros], -1)], dim=1)
    return _affine_sample(x, theta)


def draw_rotate(generator, n: int, param: ParamDiffAug, hw=None):
    return ((_uniform(generator, n) - 0.5) * 2 * param.ratio_rotate / 180 * math.pi,)


def rotate(x, angle, param: Optional[ParamDiffAug] = None):
    """(utils.py:1752-1763)."""
    angle = angle.to(x.device, x.dtype)
    c, s = torch.cos(angle), torch.sin(angle)
    zeros = torch.zeros_like(c)
    theta = torch.stack([torch.stack([c, -s, zeros], -1), torch.stack([s, c, zeros], -1)], dim=1)
    return _affine_sample(x, theta)


def draw_uniform(generator, n: int, param: ParamDiffAug, hw=None):
    return (_uniform(generator, n),)


def flip(x, randf, param: ParamDiffAug):
    """Horizontal flip with prob_flip (utils.py:1766-1772)."""
    return torch.where(_per_sample(randf, x) < param.prob_flip, torch.flip(x, [2]), x)


def brightness(x, randb, param: ParamDiffAug):
    return x + (_per_sample(randb, x) - 0.5) * param.brightness


def saturation(x, rands, param: ParamDiffAug):
    x_mean = x.mean(dim=-1, keepdim=True)  # channel mean (torch dim=1)
    return (x - x_mean) * (_per_sample(rands, x) * param.saturation) + x_mean


def contrast(x, randc, param: ParamDiffAug):
    x_mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - x_mean) * (_per_sample(randc, x) + param.contrast) + x_mean


def draw_crop(generator, n: int, param: ParamDiffAug, hw):
    shift_y, shift_x = int(hw[0] * param.ratio_crop_pad + 0.5), int(hw[1] * param.ratio_crop_pad + 0.5)
    return (_randint(generator, -shift_y, shift_y + 1, n),
            _randint(generator, -shift_x, shift_x + 1, n))


def crop(x, ty, tx, param: Optional[ParamDiffAug] = None):
    """Pad-and-shift crop (utils.py:1807-1827): pad by 1 with zeros, then
    gather the shifted window (indices clipped to the padded image)."""
    B, H, W, C = x.shape
    ty = ty.to(x.device).reshape(-1, 1, 1)
    tx = tx.to(x.device).reshape(-1, 1, 1)
    gy = torch.clamp(torch.arange(H, device=x.device)[None, :, None] + ty + 1, 0, H + 1)
    gx = torch.clamp(torch.arange(W, device=x.device)[None, None, :] + tx + 1, 0, W + 1)
    x_pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    b = torch.arange(B, device=x.device)[:, None, None]
    return x_pad[b, gy.expand(B, H, W), gx.expand(B, H, W)]


def draw_cutout(generator, n: int, param: ParamDiffAug, hw):
    ch, cw = int(hw[0] * param.ratio_cutout + 0.5), int(hw[1] * param.ratio_cutout + 0.5)
    return (_randint(generator, 0, hw[0] + (1 - ch % 2), n),
            _randint(generator, 0, hw[1] + (1 - cw % 2), n))


def cutout(x, oy, ox, param: ParamDiffAug):
    """Zero a random rectangle of ratio_cutout (utils.py:1830-1848)."""
    B, H, W, C = x.shape
    ch, cw = int(H * param.ratio_cutout + 0.5), int(W * param.ratio_cutout + 0.5)
    oy = oy.to(x.device).reshape(-1, 1, 1)
    ox = ox.to(x.device).reshape(-1, 1, 1)
    yy = torch.arange(H, device=x.device)[None, :, None]
    xx = torch.arange(W, device=x.device)[None, None, :]
    y0, x0 = oy - ch // 2, ox - cw // 2
    in_cut = (yy >= y0) & (yy < y0 + ch) & (xx >= x0) & (xx < x0 + cw)
    return x * (~in_cut)[..., None].to(x.dtype)


# name -> (draw(generator, n, param, (H, W)) -> draws, transform(x, *draws, param))
TRANSFORMS: Dict[str, tuple] = {
    "scale": (draw_scale, scale),
    "rotate": (draw_rotate, rotate),
    "flip": (draw_uniform, flip),
    "brightness": (draw_uniform, brightness),
    "saturation": (draw_uniform, saturation),
    "contrast": (draw_uniform, contrast),
    "crop": (draw_crop, crop),
    "cutout": (draw_cutout, cutout),
}


def _rand(name: str):
    draw, transform = TRANSFORMS[name]

    def rand_fn(x, generator: torch.Generator, param: ParamDiffAug, siamese: bool = False):
        draws = draw(generator, 1 if siamese else x.shape[0], param, tuple(x.shape[1:3]))
        return transform(x, *draws, param)

    rand_fn.__name__ = f"rand_{name}"
    return rand_fn


rand_scale, rand_rotate, rand_flip = _rand("scale"), _rand("rotate"), _rand("flip")
rand_brightness, rand_saturation, rand_contrast = (_rand("brightness"), _rand("saturation"),
                                                   _rand("contrast"))
rand_crop, rand_cutout = _rand("crop"), _rand("cutout")

AUGMENT_FNS: Dict[str, List[Callable]] = {
    "color": [rand_brightness, rand_saturation, rand_contrast],
    "crop": [rand_crop],
    "cutout": [rand_cutout],
    "flip": [rand_flip],
    "scale": [rand_scale],
    "rotate": [rand_rotate],
}


def diff_augment(
    x: torch.Tensor,
    strategy: str = "",
    generator: Optional[torch.Generator] = None,
    param: Optional[ParamDiffAug] = None,
    siamese: bool = False,
) -> torch.Tensor:
    """DiffAugment entry (utils.py:1705-1730) on NHWC ``x``. Mode 'S' picks
    ONE strategy, on the host, from ``generator``; mode 'M' applies them all
    in order. ``siamese=True`` gives every sample one draw; two calls with
    generators of one seed then transform their batches alike (the
    reference's seed-synchronized two-branch mode). ``generator`` defaults
    to a CPU generator of seed 0."""
    if strategy in ("None", "none", ""):
        return x
    param = param or ParamDiffAug()
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    parts = strategy.split("_")
    if param.aug_mode == "M":
        for p in parts:
            for f in AUGMENT_FNS[p]:
                x = f(x, generator, param, siamese)
        return x
    if param.aug_mode == "S":
        choice = int(torch.randint(0, len(parts), (), generator=generator,
                                   device=generator.device))
        for f in AUGMENT_FNS[parts[choice]]:
            x = f(x, generator, param, siamese)
        return x
    raise ValueError(f"unknown augmentation mode: {param.aug_mode}")


# ---------------------------------------------------------------------------
# CPU augment (utils.py:1574-1633) — host-side numpy, non-differentiable
# ---------------------------------------------------------------------------

def augment(images: np.ndarray, dc_aug_param: Optional[dict], rng=None) -> np.ndarray:
    """Per-sample random crop/scale/rotate/noise (utils.py:1574-1633).
    images: [B, H, W, C] numpy; returns a new array."""
    if dc_aug_param is None or dc_aug_param.get("strategy", "none") == "none":
        return images
    from scipy.ndimage import rotate as scipyrotate
    from scipy.ndimage import zoom

    rng = rng or np.random.default_rng()
    images = images.copy()
    B, H, W, C = images.shape
    crop_, scale_ = dc_aug_param["crop"], dc_aug_param["scale"]
    rot, noise = dc_aug_param["rotate"], dc_aug_param["noise"]
    mean = images.mean(axis=(0, 1, 2))
    augs = dc_aug_param["strategy"].split("_")

    for i in range(B):
        choice = rng.permutation(augs)[0]
        if choice == "crop":
            im_ = np.broadcast_to(mean, (H + crop_ * 2, W + crop_ * 2, C)).copy()
            im_[crop_ : crop_ + H, crop_ : crop_ + W] = images[i]
            r, c = rng.integers(0, crop_ * 2 + 1, 2)
            images[i] = im_[r : r + H, c : c + W]
        elif choice == "scale":
            h = int(rng.uniform(1 - scale_, 1 + scale_) * H)
            w = int(rng.uniform(1 - scale_, 1 + scale_) * H)
            tmp = zoom(images[i], (h / H, w / W, 1), order=1)
            mhw = max(h, w, H, W)
            im_ = np.zeros((mhw, mhw, C), np.float32)
            r, c = (mhw - h) // 2, (mhw - w) // 2
            im_[r : r + h, c : c + w] = tmp
            r, c = (mhw - H) // 2, (mhw - W) // 2
            images[i] = im_[r : r + H, c : c + W]
        elif choice == "rotate":
            im_ = scipyrotate(
                images[i], angle=float(rng.integers(-rot, rot)), axes=(0, 1),
                cval=float(mean.mean()),
            )
            r = (im_.shape[0] - H) // 2
            c = (im_.shape[1] - W) // 2
            images[i] = im_[r : r + H, c : c + W]
        elif choice == "noise":
            images[i] = images[i] + noise * rng.normal(size=(H, W, C)).astype(np.float32)
    return images


def get_daparam(dataset: str, model: str, model_eval: str, ipc: int) -> dict:
    """(utils.py:1641-1657)."""
    p = {"crop": 4, "scale": 0.2, "rotate": 45, "noise": 0.001, "strategy": "none"}
    if dataset == "MNIST":
        p["strategy"] = "crop_scale_rotate"
    if model_eval in ("ConvNetBN",):
        p["strategy"] = "crop_noise"
    return p


def get_eval_pool(eval_mode: str, model: str, model_eval: str) -> List[str]:
    """Architecture pools for condensation evaluation (utils.py:1660-1680)."""
    pools = {
        "M": ["MLP", "ConvNet", "LeNet", "AlexNet", "VGG11", "ResNet18"],
        "B": ["ConvNetBN", "ConvNetASwishBN", "AlexNetBN", "VGG11BN", "ResNet18BN"],
        "W": ["ConvNetW32", "ConvNetW64", "ConvNetW128", "ConvNetW256"],
        "D": ["ConvNetD1", "ConvNetD2", "ConvNetD3", "ConvNetD4"],
        "A": ["ConvNetAS", "ConvNetAR", "ConvNetAL", "ConvNetASwish"],
        "P": ["ConvNetNP", "ConvNetMP", "ConvNetAP"],
        "N": ["ConvNetNN", "ConvNetBN", "ConvNetLN", "ConvNetIN", "ConvNetGN"],
    }
    if eval_mode in pools:
        return pools[eval_mode]
    if eval_mode == "S":
        return [model[: model.index("BN")]] if "BN" in model else [model]
    if eval_mode == "SS":
        return [model]
    return [model_eval]


# ---------------------------------------------------------------------------
# condensation train loops (utils.py:1485-1572)
# ---------------------------------------------------------------------------

_STATS = ("running_mean", "running_var")


def parameters(variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameter entries of a ``models.zoo`` state dict, without the
    BatchNorm running statistics (JAX's ``variables["params"]``)."""
    return {k: v for k, v in variables.items() if not k.endswith(_STATS)}


def trainable_variables(variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``variables`` whose parameter entries are trainable leaf
    tensors (``fl.training.trainable``); hand ``parameters(...)`` of it to
    ``optimizer.init`` and it to the train loops, which update it in place."""
    return {**variables, **trainable(parameters(variables))}


def _nll_and_correct(logits: torch.Tensor, y: torch.Tensor):
    # at least float32 (bf16 logits are widened); float64 stays float64
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    nll = -torch.gather(logp, 1, y[:, None])[:, 0]
    return nll, torch.sum(torch.argmax(logits, -1) == y)


def _device(variables) -> torch.device:
    return next(iter(variables.values())).device


def gradient_match(apply_fn: Callable, variables, real, syn,
                   dis_metric: str = "ours") -> torch.Tensor:
    """The condensation step's loss for one class: ``match_loss`` between
    the parameters' gradient of the mean cross-entropy on the synthetic
    batch (kept in the graph, so the loss backpropagates into the synthetic
    images) and on the real batch (detached). ``real`` and ``syn`` are
    (images, labels) tensors; ``variables`` come from
    :func:`trainable_variables`."""
    leaves = list(parameters(variables).values())

    def grads(x, y, create_graph):
        nll, _ = _nll_and_correct(apply_fn(variables, x), y.long())
        return torch.autograd.grad(nll.mean(), leaves, create_graph=create_graph)

    gw_real = [g.detach() for g in grads(*real, False)]
    return match_loss(grads(*syn, True), gw_real, dis_metric)


def run_epoch(
    mode: str,
    ds: ArrayDataset,
    apply_fn: Callable,
    variables,
    opt_state=None,
    batch_size: int = 64,
    aug_fn: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
):
    """One epoch of train/eval (utils.py:1485-1525 ``epoch``). In train
    mode ``variables`` come from :func:`trainable_variables` and
    ``opt_state`` is the optimizer, ``optimizer.init(parameters(variables))``
    (a ``torch.optim`` optimizer over them; JAX's separate ``optimizer``
    argument has no counterpart); each batch steps it, updating
    ``variables`` in place. ``aug_fn(x, generator)``
    transforms each batch on the device. Returns (loss_avg, acc_avg,
    variables, opt_state)."""
    device = _device(variables)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    loss_sum, acc_sum, n_seen = 0.0, 0.0, 0
    for i in range(0, len(ds), batch_size):
        x = torch.as_tensor(ds.images[i : i + batch_size], device=device)
        y = torch.as_tensor(ds.labels[i : i + batch_size], device=device).long()
        if aug_fn is not None:
            x = aug_fn(x, generator)
        if mode == "train":
            opt_state.zero_grad(set_to_none=True)
            nll, acc = _nll_and_correct(apply_fn(variables, x), y)
            loss = nll.mean()
            loss.backward()
            opt_state.step()
        else:
            with torch.no_grad():
                nll, acc = _nll_and_correct(apply_fn(variables, x), y)
                loss = nll.mean()
        nb = len(y)
        loss_sum += float(loss.detach()) * nb
        acc_sum += float(acc)
        n_seen += nb
    return loss_sum / n_seen, acc_sum / n_seen, variables, opt_state


def run_epoch_data_weight(
    ds: SynDataset,
    apply_fn: Callable,
    variables,
    opt_state,
    data_weights: Optional[np.ndarray] = None,
    batch_size: int = 64,
    aug_fn: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
):
    """Weighted condensation training (utils.py:1527-1572
    ``epoch_data_weight``): per-sample weight ``data_weights[label][src]``
    and loss ``Σ nll·w / B`` (the plain mean without weights). The same
    conventions as :func:`run_epoch`'s train mode."""
    device = _device(variables)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    loss_sum, acc_sum, n_seen = 0.0, 0.0, 0
    for i in range(0, len(ds), batch_size):
        x = torch.as_tensor(ds.images[i : i + batch_size], device=device)
        y_host = np.asarray(ds.labels[i : i + batch_size])
        src = np.asarray(ds.src[i : i + batch_size])
        y = torch.as_tensor(y_host, device=device).long()
        if aug_fn is not None:
            x = aug_fn(x, generator)
        opt_state.zero_grad(set_to_none=True)
        nll, acc = _nll_and_correct(apply_fn(variables, x), y)
        if data_weights is not None:
            w = np.asarray([data_weights[y_host[j]][src[j]] for j in range(len(y_host))],
                           np.float32)
            loss = torch.sum(nll * torch.as_tensor(w, device=device)) / len(y_host)
        else:
            loss = nll.mean()
        loss.backward()
        opt_state.step()
        nb = len(y_host)
        loss_sum += float(loss.detach()) * nb
        acc_sum += float(acc)
        n_seen += nb
    return loss_sum / n_seen, acc_sum / n_seen, variables, opt_state
