"""Model zoo: the reference's breadth models as ``torch.nn`` modules.

The port of ``shapley_vit_tpu/models/zoo.py`` (reference
``federated_learning/networks.py``: the MLP family, the configurable
ConvNet, LeNet, AlexNet(BN), VGG11-19 with instance or batch norm,
ResNet18/34/50/101/152 and their ``_AP`` average-pool variants, the
ModelHead feature extractor, Swish; and the ``get_network`` factory,
utils.py:1312-1403). No hand kernel: the convolutions are cuDNN's on the
card, as the JAX zoo is XLA's.

What the port keeps of the JAX zoo, so that flax variables carry over
(``models.convert.flax_zoo_to_state_dict``) and the outputs agree:

* inputs are NHWC, as in the JAX package; each model turns them to NCHW
  for the convolutions, and flattens ahead of a ``Linear`` in H, W, C
  order, as the JAX zoo's ``_flatten`` of an NHWC tensor does;
* every layer is named as flax names it, per type in creation order
  (``Conv_0``, ``BatchNorm_1``, ``BasicBlock_3.Conv_2``, ``Dense_0``), so
  a state-dict key is the flax path;
* :class:`BatchNorm` follows flax's ``nn.BatchNorm``: momentum 0.99 (torch's
  0.01), and the running variance moves toward the BIASED batch variance
  ``E[x²] - E[x]²`` (``nn.BatchNorm2d`` takes the unbiased one, n/(n-1)
  larger); training normalises with the biased variance, as both do;
* ``layernorm`` normalises over (C, H, W) with a per-position scale and
  bias, ``instancenorm`` is GroupNorm with one group per channel and
  ``groupnorm`` has 4 groups, all with eps 1e-5; a 28-pixel ConvNet input
  is padded to 32; the ``_AP`` ResNets' shortcut is a 1×1 convolution then
  a 2×2 average pool, and their last pool is a no-op.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish(x) = x·σ(x) (networks.py:23-28)."""
    return x * torch.sigmoid(x)


_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": torch.sigmoid,
    "relu": F.relu,
    "leakyrelu": functools.partial(F.leaky_relu, negative_slope=0.01),
    "swish": swish,
}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (eps 1e-5, momentum 0.99) on NCHW: in training,
    the batch statistics normalise and the running ones move by 0.01 toward
    the batch mean and biased variance (flax's fast variance, ``E[x²] -
    E[x]²`` clipped at 0); in eval, the running statistics normalise."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            xf = x.detach().float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self.running_mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` over (C, H, W), eps 1e-5; scale and bias [C, H, W]
    (flax keeps them [H, W, C])."""

    def __init__(self, shape: Tuple[int, int, int], eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, tuple(self.weight.shape), self.weight, self.bias, self.eps)


def _norm_layer(net_norm: str, channels: int, hw: Tuple[int, int] = (0, 0)) -> Tuple[str, nn.Module]:
    """(flax layer type, module) for ``net_norm`` (networks.py:124-131)."""
    if net_norm == "batchnorm":
        return "BatchNorm", BatchNorm(channels)
    if net_norm == "layernorm":
        return "LayerNorm", LayerNorm((channels, hw[0], hw[1]))
    if net_norm == "instancenorm":
        return "GroupNorm", nn.GroupNorm(channels, channels, eps=1e-5)
    if net_norm == "groupnorm":
        return "GroupNorm", nn.GroupNorm(4, channels, eps=1e-5)
    raise ValueError(f"unknown net_norm: {net_norm}")


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _avg_pool(x: torch.Tensor, k: int = 2, s: int = 2) -> torch.Tensor:
    return x if k == 1 and s == 1 else F.avg_pool2d(x, k, s)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B, features]; an NCHW map in H, W, C order (the JAX
    zoo's flatten of NHWC)."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


class _Flax(nn.Module):
    """A module whose children are named as flax names them: ``<Type>_<i>``,
    counted per type in creation order."""

    def __init__(self):
        super().__init__()
        self._counts: Dict[str, int] = {}

    def add(self, kind: str, module: nn.Module, ref: Optional[str] = None) -> nn.Module:
        """Register ``module`` as the next ``<kind>_<i>``; ``ref`` also
        names it as a plain attribute (not a second registration, which
        would repeat its keys in the state dict)."""
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        if ref is not None:
            object.__setattr__(self, ref, module)
        return module

    def norm(self, net_norm: str, channels: int, hw: Tuple[int, int] = (0, 0)) -> nn.Module:
        return self.add(*_norm_layer(net_norm, channels, hw))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The ModelHead features (networks.py:9-19): the flattened output
        of ``features``."""
        return _flatten(self.features(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.embed(x))


# ---------------------------------------------------------------------------
# MLP family (networks.py:32-75)
# ---------------------------------------------------------------------------

class _Dense(_Flax):
    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.layers = [self.add("Dense", nn.Linear(a, b)) for a, b in zip(sizes, sizes[1:])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)  # NHWC rows, flattened as JAX does
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class MLP(_Dense):
    def __init__(self, channel: int, num_classes: int, im_size=(32, 32)):
        super().__init__([im_size[0] * im_size[1] * channel, 128, 128, num_classes])


class MLP_linear(_Dense):
    def __init__(self, input_size: int, num_classes: int):
        super().__init__([input_size, num_classes])


class MLP_tabular(_Dense):
    def __init__(self, input_size: int, num_classes: int):
        super().__init__([input_size, 64, 128, 256, 512, num_classes])


# ---------------------------------------------------------------------------
# ConvNet (networks.py:78-152)
# ---------------------------------------------------------------------------

class ConvNet(_Flax):
    def __init__(self, channel: int, num_classes: int, net_width: int = 128, net_depth: int = 3,
                 net_act: str = "relu", net_norm: str = "instancenorm",
                 net_pooling: str = "avgpooling", im_size: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.act = _ACTS[net_act]
        self.net_norm, self.net_pooling = net_norm, net_pooling
        hw = (32, 32) if tuple(im_size)[0] == 28 else tuple(im_size)
        in_c, self.blocks = channel, []
        for d in range(net_depth):
            pad = 3 if channel == 1 and d == 0 else 1
            conv = self.add("Conv", nn.Conv2d(in_c, net_width, 3, padding=pad))
            hw = (hw[0] + 2 * pad - 2, hw[1] + 2 * pad - 2)
            norm = self.norm(net_norm, net_width, hw) if net_norm != "none" else None
            if net_pooling != "none":
                hw = (hw[0] // 2, hw[1] // 2)
            self.blocks.append((conv, norm))
            in_c = net_width
        self.add("Dense", nn.Linear(net_width * hw[0] * hw[1], num_classes), ref="classifier")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 28:  # 28x28 inputs padded up to 32 (networks.py:138)
            x = F.pad(x, (0, 0, 2, 2, 2, 2))
        x = _nchw(x)
        for conv, norm in self.blocks:
            x = conv(x)
            if norm is not None:
                x = norm(x)
            x = self.act(x)
            if self.net_pooling == "maxpooling":
                x = _max_pool(x)
            elif self.net_pooling == "avgpooling":
                x = _avg_pool(x)
        return x


# ---------------------------------------------------------------------------
# LeNet (networks.py:157-178)
# ---------------------------------------------------------------------------

class LeNet(_Flax):
    def __init__(self, channel: int, num_classes: int, im_size=(32, 32)):
        super().__init__()
        self.add("Conv", nn.Conv2d(channel, 6, 5, padding=2 if channel == 1 else 0), ref="conv0")
        self.add("Conv", nn.Conv2d(6, 16, 5), ref="conv1")
        h = ((im_size[0] + (4 if channel == 1 else 0) - 4) // 2 - 4) // 2
        w = ((im_size[1] + (4 if channel == 1 else 0) - 4) // 2 - 4) // 2
        self.fc = [self.add("Dense", nn.Linear(a, b))
                   for a, b in ((16 * h * w, 120), (120, 84), (84, num_classes))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _max_pool(F.relu(self.conv0(_nchw(x))))
        x = _flatten(_max_pool(F.relu(self.conv1(x))))
        x = F.relu(self.fc[0](x))
        x = F.relu(self.fc[1](x))
        return self.fc[2](x)


# ---------------------------------------------------------------------------
# AlexNet (networks.py:183-250)
# ---------------------------------------------------------------------------

class AlexNet(_Flax):
    _LAYERS = ((128, 5, None), (192, 5, 2), (256, 3, 1), (192, 3, 1), (192, 3, 1))
    _POOL = (True, True, False, False, True)

    def __init__(self, channel: int, num_classes: int, use_bn: bool = False, im_size=(32, 32)):
        super().__init__()
        in_c, self.blocks = channel, []
        h, w = im_size
        for i, (out_c, k, pad) in enumerate(self._LAYERS):
            pad = (4 if channel == 1 else 2) if pad is None else pad
            conv = self.add("Conv", nn.Conv2d(in_c, out_c, k, padding=pad))
            h, w = h + 2 * pad - k + 1, w + 2 * pad - k + 1
            if self._POOL[i]:
                h, w = h // 2, w // 2
            self.blocks.append((conv, self.add("BatchNorm", BatchNorm(out_c)) if use_bn else None))
            in_c = out_c
        self.add("Dense", nn.Linear(192 * h * w, num_classes), ref="classifier")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for (conv, bn), pool in zip(self.blocks, self._POOL):
            x = conv(x)
            x = F.relu(bn(x) if bn is not None else x)
            if pool:
                x = _max_pool(x)
        return x


# ---------------------------------------------------------------------------
# VGG (networks.py:254-302)
# ---------------------------------------------------------------------------

CFG_VGG = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
              "M", 512, 512, 512, 512, "M"],
}


class VGG(_Flax):
    def __init__(self, vgg_name: str, channel: int, num_classes: int, norm: str = "instancenorm",
                 im_size=(32, 32)):
        super().__init__()
        in_c, self.layers = channel, []
        h, w = im_size
        for ic, v in enumerate(CFG_VGG[vgg_name]):
            if v == "M":
                self.layers.append(None)
                h, w = h // 2, w // 2
                continue
            pad = 3 if channel == 1 and ic == 0 else 1
            conv = self.add("Conv", nn.Conv2d(in_c, v, 3, padding=pad))
            h, w = h + 2 * pad - 2, w + 2 * pad - 2
            self.layers.append((conv, self.norm(norm, v, (h, w))))
            in_c = v
        self.add("Dense", nn.Linear(512 * h * w, num_classes), ref="classifier")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for layer in self.layers:
            if layer is None:
                x = _max_pool(x)
            else:
                x = F.relu(layer[1](layer[0](x)))
        return _avg_pool(x, k=1, s=1)


# ---------------------------------------------------------------------------
# ResNet (networks.py:422-538) + _AP variants (networks.py:305-418)
# ---------------------------------------------------------------------------

class _Block(_Flax):
    """BasicBlock (expansion 1: 3×3, 3×3) or Bottleneck (expansion 4: 1×1,
    3×3, 1×1). ``avg_pool_variant`` (_AP): the strided convolution runs at
    stride 1 and a 2×2 average pool follows it and the shortcut."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, norm: str = "instancenorm",
                 avg_pool_variant: bool = False):
        super().__init__()
        self.stride, self.ap = stride, avg_pool_variant
        conv_stride = 1 if avg_pool_variant else stride
        out = planes * self.expansion
        if self.expansion == 1:
            convs = [(in_planes, planes, 3, conv_stride, 1), (planes, planes, 3, 1, 1)]
        else:
            convs = [(in_planes, planes, 1, 1, 0), (planes, planes, 3, conv_stride, 1),
                     (planes, out, 1, 1, 0)]
        self.body = []
        for i, (a, b, k, s, p) in enumerate(convs):
            conv = self.add("Conv", nn.Conv2d(a, b, k, stride=s, padding=p, bias=False))
            self.body.append((conv, self.norm(norm, b)))
        self.shortcut = None
        if stride != 1 or in_planes != out:
            sc = self.add("Conv", nn.Conv2d(in_planes, out, 1,
                                            stride=1 if avg_pool_variant else stride, bias=False))
            self.shortcut = (sc, self.norm(norm, out))
        # the strided convolution: the first of a BasicBlock, the second of a Bottleneck
        self._pool_after = 0 if self.expansion == 1 else 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i, (conv, norm) in enumerate(self.body):
            out = norm(conv(out))
            if i < len(self.body) - 1:
                out = F.relu(out)
            if self.ap and self.stride != 1 and i == self._pool_after:
                out = _avg_pool(out)
        if self.shortcut is not None:
            sc = self.shortcut[0](x)
            if self.ap:
                sc = _avg_pool(sc)
            sc = self.shortcut[1](sc)
        else:
            sc = x
        return F.relu(out + sc)


class BasicBlock(_Block):
    expansion = 1


class Bottleneck(_Block):
    expansion = 4


class ResNet(_Flax):
    def __init__(self, block, num_blocks: Sequence[int], channel: int = 3, num_classes: int = 10,
                 norm: str = "instancenorm", avg_pool_variant: bool = False, im_size=(32, 32)):
        super().__init__()
        self.ap = avg_pool_variant
        self.stem = (self.add("Conv", nn.Conv2d(channel, 64, 3, padding=1, bias=False)),
                     self.norm(norm, 64))
        in_planes, self.blocks = 64, []
        h, w = im_size
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), num_blocks)):
            for s in [1 if stage == 0 else 2] + [1] * (n - 1):
                self.blocks.append(self.add(block.__name__,
                                            block(in_planes, planes, s, norm, avg_pool_variant)))
                in_planes = planes * block.expansion
                if s == 2:  # a 2x2 pool (_AP) floors; a stride-2 3x3 conv rounds up
                    h, w = (h // 2, w // 2) if avg_pool_variant else ((h + 1) // 2, (w + 1) // 2)
        if not avg_pool_variant:
            h, w = (h - 4) // 4 + 1, (w - 4) // 4 + 1
        self.add("Dense", nn.Linear(in_planes * h * w, num_classes), ref="classifier")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem[1](self.stem[0](_nchw(x))))
        for blk in self.blocks:
            x = blk(x)
        if self.ap:
            return _avg_pool(x, k=1, s=1)  # networks.py:398 (no-op pool)
        return _avg_pool(x, k=4, s=4)  # networks.py:508 F.avg_pool2d(out, 4)


# ---------------------------------------------------------------------------
# factory (utils.py:1312-1403)
# ---------------------------------------------------------------------------

def model_head(module: nn.Module):
    """Feature-extractor wrapper (reference ModelHead, networks.py:9-19):
    ``apply_fn(variables, x, train=False) -> [B, features]`` through the
    module's ``embed``; ``variables`` a state dict of the module."""
    if not hasattr(module, "features"):
        raise ValueError(f"{type(module).__name__} exposes no embed() features")

    def apply_fn(variables, x, train: bool = False):
        module.train(train)
        return _call(module, variables, x, "embed")

    return apply_fn


class _Method(nn.Module):
    """``module.<method>`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, x):
        return getattr(self.m, self.method)(x)


def _call(module: nn.Module, variables, x: torch.Tensor, method: str = "forward"):
    """``module.<method>(x)`` with its parameters and buffers taken from
    ``variables`` (a state dict; BatchNorm's running statistics in it are
    updated in place in training)."""
    if method == "forward":
        return torch.func.functional_call(module, variables, (x,))
    return torch.func.functional_call(_Method(module, method),
                                      {f"m.{k}": v for k, v in variables.items()}, (x,))


def make_coalition_forward(module: nn.Module):
    """``forward_fn(shared, stacked_variables, images) -> logits [C, B, K]``
    for the coalition evaluator over whole-model variables: each
    coalition's state dict (parameters and BatchNorm statistics, stacked on
    a leading ``[C]`` axis, as ``ops.tree_math.materialize_coalitions``
    makes them from FedAvg deltas) through ``module`` in eval mode, one
    coalition after another. ``shared`` is unused: the whole model varies
    (the reference aggregates entire state dicts, utils.py:735-749)."""

    def forward_fn(_shared, stacked, x):
        module.eval()
        n = next(iter(stacked.values())).shape[0]
        return torch.stack([_call(module, {k: v[c] for k, v in stacked.items()}, x)
                            for c in range(n)])

    return forward_fn


def get_default_convnet_setting():
    """(utils.py:1306-1308)."""
    return 128, 3, "relu", "instancenorm", "avgpooling"


def _convnet(channel, num_classes, im_size, **overrides):
    w, d, a, n, p = get_default_convnet_setting()
    kw = dict(net_width=w, net_depth=d, net_act=a, net_norm=n, net_pooling=p)
    kw.update(overrides)
    return ConvNet(channel=channel, num_classes=num_classes, im_size=tuple(im_size), **kw)


def _flat_size(im_size) -> int:
    return im_size if isinstance(im_size, int) else int(im_size[0])


def build_network(model: str, channel: int, num_classes: int, im_size=(32, 32)) -> nn.Module:
    """Name -> module (the reference's ~30 named variants, utils.py:1316-1390).
    ``im_size`` is the input's (H, W) (for the tabular MLPs: the feature
    count), which the port needs up front to size each Dense and LayerNorm
    (flax infers them at ``init``)."""
    if model == "MLP":
        return MLP(channel=channel, num_classes=num_classes, im_size=im_size)
    if model == "MLP_tabular":
        return MLP_tabular(input_size=_flat_size(im_size), num_classes=num_classes)
    if model == "MLP_linear":
        return MLP_linear(input_size=_flat_size(im_size), num_classes=num_classes)
    if model == "LeNet":
        return LeNet(channel=channel, num_classes=num_classes, im_size=im_size)
    if model == "AlexNet":
        return AlexNet(channel=channel, num_classes=num_classes, im_size=im_size)
    if model == "AlexNetBN":
        return AlexNet(channel=channel, num_classes=num_classes, use_bn=True, im_size=im_size)
    if model.startswith("VGG"):
        bn = model.endswith("BN")
        base = model[:-2] if bn else model
        if base not in CFG_VGG:
            raise ValueError(f"unknown model: {model}")
        return VGG(vgg_name=base, channel=channel, num_classes=num_classes,
                   norm="batchnorm" if bn else "instancenorm", im_size=im_size)
    if model.startswith("ResNet"):
        ap = model.endswith("_AP")
        core = model[:-3] if ap else model
        bn = core.endswith("BN")
        core = core[:-2] if bn else core
        depths = {
            "ResNet18": (BasicBlock, [2, 2, 2, 2]),
            "ResNet34": (BasicBlock, [3, 4, 6, 3]),
            "ResNet50": (Bottleneck, [3, 4, 6, 3]),
            "ResNet101": (Bottleneck, [3, 4, 23, 3]),
            "ResNet152": (Bottleneck, [3, 8, 36, 3]),
        }
        if core not in depths:
            raise ValueError(f"unknown model: {model}")
        block, nb = depths[core]
        return ResNet(block=block, num_blocks=nb, channel=channel, num_classes=num_classes,
                      norm="batchnorm" if bn else "instancenorm", avg_pool_variant=ap,
                      im_size=im_size)
    if model.startswith("ConvNet"):
        suffix = model[len("ConvNet"):]
        if suffix == "":
            return _convnet(channel, num_classes, im_size)
        if suffix.startswith("D") and suffix[1:].isdigit():
            return _convnet(channel, num_classes, im_size, net_depth=int(suffix[1:]))
        if suffix.startswith("W") and suffix[1:].isdigit():
            return _convnet(channel, num_classes, im_size, net_width=int(suffix[1:]))
        acts = {"AS": "sigmoid", "AR": "relu", "AL": "leakyrelu", "ASwish": "swish"}
        if suffix in acts:
            return _convnet(channel, num_classes, im_size, net_act=acts[suffix])
        if suffix == "ASwishBN":
            return _convnet(channel, num_classes, im_size, net_act="swish", net_norm="batchnorm")
        norms = {"NN": "none", "BN": "batchnorm", "LN": "layernorm",
                 "IN": "instancenorm", "GN": "groupnorm"}
        if suffix in norms:
            return _convnet(channel, num_classes, im_size, net_norm=norms[suffix])
        pools = {"NP": "none", "MP": "maxpooling", "AP": "avgpooling"}
        if suffix in pools:
            return _convnet(channel, num_classes, im_size, net_pooling=pools[suffix])
    raise ValueError(f"unknown model: {model}")


def get_network(model: str, channel: int, num_classes: int, im_size=(32, 32),
                seed: int = 0, device="cuda") -> Tuple[nn.Module, Dict[str, torch.Tensor], Callable]:
    """Factory parity (utils.py:1312-1403): build, initialise from ``seed``
    (torch's default initialisers; the global generator is left as it
    was), and place on ``device``.

    Returns ``(module, variables, apply_fn)``: ``variables`` is a copy of
    the module's state dict (parameters and BatchNorm statistics, the JAX
    ``{params, batch_stats}``), and ``apply_fn(variables, x, train=False)
    -> logits``; in train mode with BatchNorm, ``(logits, new_stats)``,
    the updated running statistics (``variables`` is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = build_network(model, channel, num_classes, im_size)
    module = module.to(device)
    variables = {k: v.detach().clone() for k, v in module.state_dict().items()}
    bn = any(isinstance(m, BatchNorm) for m in module.modules())

    def apply_fn(variables, x, train: bool = False):
        module.train(train)
        if train and bn:
            stats = {k: v.clone() for k, v in variables.items() if k.endswith(("running_mean",
                                                                              "running_var"))}
            out = _call(module, {**variables, **stats}, x)
            return out, stats
        return _call(module, variables, x)

    return module, variables, apply_fn
