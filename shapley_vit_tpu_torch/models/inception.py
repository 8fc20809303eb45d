"""Inception-v3 with the U-Net-style ``Denoise`` front-end for adversarial
defense, plus the paired orig/adv training ``Net`` and its losses.

The port of ``shapley_vit_tpu/models/inception.py`` (reference
``shapleyserver/models/inception.py``: InceptionV3 at 329-430, Denoise
261-327, DenoiseLoss/Loss 433-466, paired forward Net 469-493, ``get_net``
495-509; the 4-class wrapper ``xray_inception_network.inception_network``,
9-27, whose num_classes is always 4).

What changed in the port:

* ``torch.nn`` modules, NCHW inside; each module's ``forward`` takes and
  returns NHWC, as the JAX modules do, and ``nchw`` is the same function on
  NCHW tensors, which the modules compose.
* Submodules carry the reference's names (``conv2d_1a``,
  ``Mixed_5b.branch0.0``, ``Mixed_7b.branch1_1``, ``classif``, each
  ``BasicConv2d`` as ``conv`` + ``bn``; ``denoise`` inside ``Inception3``),
  so a reference-format state dict loads straight into ``Inception3``
  (``models.convert.load_inception_state_dict``).
* Train/eval is the module's mode (``.train()`` / ``.eval()``), where JAX
  passes ``train``. BatchNorm's momentum is flax's (0.99 for the running
  averages, torch momentum 0.01); torch updates the running variance with
  the unbiased batch variance where flax uses the biased one, so the two
  agree in eval mode and differ slightly after training steps.
* ``Inception3`` takes ``image_size``: ``torch.nn.Linear`` needs its input
  width when it is built, where flax infers it at the first call. An input
  whose last feature map is under 5 px pools to no feature at all, as flax's
  VALID pooling does (the classifier is then its bias).
* Convolutions, pooling, BatchNorm and the bilinear upsampling are
  ``torch.nn.functional`` ops: the JAX package computes them in XLA, with no
  Pallas kernel. ``F.interpolate(mode="bilinear", align_corners=False)``
  upsamples as ``jax.image.resize(..., "bilinear")`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _trunc_normal_(w: torch.Tensor, std: float) -> torch.Tensor:
    """flax ``truncated_normal(std, lower=-2, upper=2)``."""
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax's default kernel init: truncated normal of variance 1/fan_in."""
    fan_in = w[0].numel()
    return _trunc_normal_(w, math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def _dense(n_in: int, n_out: int, std: Optional[float] = None) -> nn.Linear:
    fc = nn.Linear(n_in, n_out)
    if std is None:
        _lecun_normal_(fc.weight)
    else:
        _trunc_normal_(fc.weight, std)
    nn.init.zeros_(fc.bias)
    return fc


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten ``[B, C, H, W]`` in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _NHWC(nn.Module):
    """``forward`` takes and returns NHWC; subclasses define ``nchw``."""

    def forward(self, x):
        return self.nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Chain(nn.Sequential):
    """A Sequential of the modules here, composed in NCHW."""

    def nchw(self, x):
        for m in self:
            x = m.nchw(x)
        return x

    forward = _NHWC.forward


class _AvgPool3(_NHWC):
    """AvgPool2d(3, stride=1, padding=1, count_include_pad=False)."""

    def nchw(self, x):
        return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class BasicConv2d(_NHWC):
    """Bias-free conv + BatchNorm (eps 1e-3) + ReLU (inception.py:187-196)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3), stride: int = 1,
                 padding=0, stddev: float = 0.1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, bias=False)
        _trunc_normal_(self.conv.weight, stddev)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, momentum=0.01)

    def nchw(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(_NHWC):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch0 = _Chain(BasicConv2d(in_channels, 64, (1, 1)))
        self.branch1 = _Chain(BasicConv2d(in_channels, 48, (1, 1)),
                              BasicConv2d(48, 64, (5, 5), padding=2))
        self.branch2 = _Chain(BasicConv2d(in_channels, 64, (1, 1)),
                              BasicConv2d(64, 96, (3, 3), padding=1),
                              BasicConv2d(96, 96, (3, 3), padding=1))
        self.branch3 = _Chain(_AvgPool3(), BasicConv2d(in_channels, pool_features, (1, 1)))

    def nchw(self, x):
        return torch.cat([b.nchw(x) for b in (self.branch0, self.branch1, self.branch2,
                                               self.branch3)], dim=1)


class InceptionB(_NHWC):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch0 = _Chain(BasicConv2d(in_channels, 384, (3, 3), stride=2))
        self.branch1 = _Chain(BasicConv2d(in_channels, 64, (1, 1)),
                              BasicConv2d(64, 96, (3, 3), padding=1),
                              BasicConv2d(96, 96, (3, 3), stride=2))

    def nchw(self, x):
        return torch.cat([self.branch0.nchw(x), self.branch1.nchw(x),
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(_NHWC):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch0 = _Chain(BasicConv2d(in_channels, 192, (1, 1)))
        self.branch1 = _Chain(BasicConv2d(in_channels, c7, (1, 1)),
                              BasicConv2d(c7, c7, (1, 7), padding=(0, 3)),
                              BasicConv2d(c7, 192, (7, 1), padding=(3, 0)))
        self.branch2 = _Chain(BasicConv2d(in_channels, c7, (1, 1)),
                              BasicConv2d(c7, c7, (7, 1), padding=(3, 0)),
                              BasicConv2d(c7, c7, (1, 7), padding=(0, 3)),
                              BasicConv2d(c7, c7, (7, 1), padding=(3, 0)),
                              BasicConv2d(c7, 192, (1, 7), padding=(0, 3)))
        self.branch3 = _Chain(_AvgPool3(), BasicConv2d(in_channels, 192, (1, 1)))

    def nchw(self, x):
        return torch.cat([b.nchw(x) for b in (self.branch0, self.branch1, self.branch2,
                                               self.branch3)], dim=1)


class InceptionD(_NHWC):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch0 = _Chain(BasicConv2d(in_channels, 192, (1, 1)),
                              BasicConv2d(192, 320, (3, 3), stride=2))
        self.branch1 = _Chain(BasicConv2d(in_channels, 192, (1, 1)),
                              BasicConv2d(192, 192, (1, 7), padding=(0, 3)),
                              BasicConv2d(192, 192, (7, 1), padding=(3, 0)),
                              BasicConv2d(192, 192, (3, 3), stride=2))

    def nchw(self, x):
        return torch.cat([self.branch0.nchw(x), self.branch1.nchw(x),
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(_NHWC):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch0 = _Chain(BasicConv2d(in_channels, 320, (1, 1)))
        self.branch1_0 = BasicConv2d(in_channels, 384, (1, 1))
        self.branch1_1 = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch1_2 = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch2_0 = BasicConv2d(in_channels, 448, (1, 1))
        self.branch2_1 = BasicConv2d(448, 384, (3, 3), padding=1)
        self.branch2_2 = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch2_3 = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3 = _Chain(_AvgPool3(), BasicConv2d(in_channels, 192, (1, 1)))

    def nchw(self, x):
        b1 = self.branch1_0.nchw(x)
        b1 = torch.cat([self.branch1_1.nchw(b1), self.branch1_2.nchw(b1)], dim=1)
        b2 = self.branch2_1.nchw(self.branch2_0.nchw(x))
        b2 = torch.cat([self.branch2_2.nchw(b2), self.branch2_3.nchw(b2)], dim=1)
        return torch.cat([self.branch0.nchw(x), b1, b2, self.branch3.nchw(x)], dim=1)


class InceptionAux(_NHWC):
    """Auxiliary head (inception.py:160-182) with its reduced init stddevs,
    on the 17 px, ``in_channels``-channel map it is built for (a 5 x 5 /3
    pool to 5 px, a 5 x 5 conv to 1 px). Returns logits."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv0 = BasicConv2d(in_channels, 128, (1, 1))
        self.conv1 = BasicConv2d(128, 768, (5, 5), stddev=0.01)
        self.fc = _dense(768, num_classes, std=0.001)

    def nchw(self, x):
        x = self.conv1.nchw(self.conv0.nchw(F.avg_pool2d(x, 5, stride=3)))
        return self.fc(_flatten_nhwc(x))

    def forward(self, x):
        return self.nchw(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Denoise U-Net (inception.py:200-327)
# ---------------------------------------------------------------------------

class DenoiseConv(_NHWC):
    """Conv block (inception.py:200-211): 3 x 3 conv, BatchNorm, ReLU."""

    expansion = 1

    def __init__(self, n_in: int, n_out: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, 3, stride=stride, padding=1, bias=False)
        _lecun_normal_(self.conv.weight)
        self.bn = nn.BatchNorm2d(n_out, momentum=0.01)

    def nchw(self, x):
        return F.relu(self.bn(self.conv(x)))


def _conv_bn(n_in: int, n_out: int, k: int, stride: int = 1):
    conv = nn.Conv2d(n_in, n_out, k, stride=stride, padding=k // 2, bias=False)
    _lecun_normal_(conv.weight)
    return conv, nn.BatchNorm2d(n_out, momentum=0.01)


class DenoiseBottleneck(_NHWC):
    """Bottleneck block (inception.py:214-250): 1 x 1, 3 x 3 (stride), 1 x 1
    to 4·n_out, with a projected shortcut where the shape changes."""

    expansion = 4

    def __init__(self, n_in: int, n_out: int, stride: int = 1):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(n_in, n_out, 1)
        self.conv2, self.bn2 = _conv_bn(n_out, n_out, 3, stride)
        self.conv3, self.bn3 = _conv_bn(n_out, n_out * 4, 1)
        self.shortcut = None
        if stride != 1 or n_in != n_out * 4:
            self.shortcut = nn.Sequential(*_conv_bn(n_in, n_out * 4, 1, stride))

    def nchw(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


def _halvings(size: int, stages: int):
    """The pyramid's sizes: ``size`` halved (rounding up) per stride-2 stage."""
    sizes = []
    for _ in range(stages):
        sizes.append(size)
        size = -(-size // 2)
    return sizes


class Denoise(_NHWC):
    """U-Net-style residual denoiser (inception.py:261-327): forward pyramid
    with stride-2 stages, bilinear upsampling back with skip concatenation,
    1 x 1 projection, residual add. ``fwd.i.j`` / ``back.i.j`` is block j of
    stage i; the back stages run from the last to the first."""

    def __init__(self, h_in: int, w_in: int, block=DenoiseConv, fwd_in: int = 3,
                 fwd_out: Sequence[int] = (64, 128, 256, 256, 256),
                 num_fwd: Sequence[int] = (2, 3, 3, 3, 3),
                 back_out: Sequence[int] = (64, 128, 256, 256),
                 num_back: Sequence[int] = (2, 3, 3, 3)):
        super().__init__()
        self.hs, self.ws = _halvings(h_in, len(num_fwd)), _halvings(w_in, len(num_fwd))
        e = block.expansion
        n_in, fwd = fwd_in, []
        for i, count in enumerate(num_fwd):
            blocks = []
            for j in range(count):
                blocks.append(block(n_in, fwd_out[i], stride=2 if (j == 0 and i != 0) else 1))
                n_in = fwd_out[i] * e
            fwd.append(_Chain(*blocks))
        self.fwd = nn.ModuleList(fwd)
        back = [None] * len(num_back)
        for i in range(len(num_back) - 1, -1, -1):
            n_in += fwd_out[i] * e  # the skip from forward stage i
            blocks = []
            for _ in range(num_back[i]):
                blocks.append(block(n_in, back_out[i]))
                n_in = back_out[i] * e
            back[i] = _Chain(*blocks)
        self.back = nn.ModuleList(back)
        self.final = nn.Conv2d(n_in, fwd_in, 1, bias=False)
        _lecun_normal_(self.final.weight)

    def blocks_in_call_order(self):
        """The blocks in the order the forward calls them (flax's naming)."""
        return ([b for stage in self.fwd for b in stage]
                + [b for stage in reversed(self.back) for b in stage])

    def nchw(self, x):
        out, skips = x, []
        for i, stage in enumerate(self.fwd):
            out = stage.nchw(out)
            if i != len(self.fwd) - 1:
                skips.append(out)
        for i in range(len(self.back) - 1, -1, -1):
            out = F.interpolate(out, size=(self.hs[i], self.ws[i]), mode="bilinear",
                                align_corners=False)
            out = self.back[i].nchw(torch.cat([out, skips[i]], dim=1))
        return self.final(out) + x


# ---------------------------------------------------------------------------
# Inception3 + wrapper (inception.py:329-430, xray_inception_network.py)
# ---------------------------------------------------------------------------

def _feature_size(size: int) -> int:
    """The side of Inception3's pooled feature map for a ``size`` px input."""
    def valid(s, k, stride=1):
        return (s - k) // stride + 1

    s = valid(valid(size, 3, 2), 3)                  # conv2d_1a, conv2d_2a (2b keeps it)
    s = valid(valid(valid(s, 3, 2), 3), 3, 2)        # pool, conv2d_4a, pool
    s = valid(valid(s, 3, 2), 3, 2)                  # Mixed_6a, Mixed_7a
    return valid(s, 5, 5) if s >= 5 else 0           # the 5 x 5 / 5 average pool


class Inception3(nn.Module):
    """Inception-v3 (inception.py:329-430): NHWC images [B, H, W, 3] ->
    logits [B, num_classes]; ``defense=True`` runs the ``denoise``
    front-end first. ``knee_pooling`` (the reference's knee dataset type):
    global-average pool, max over the batch, a 2-class head."""

    def __init__(self, num_classes: int = 1001, denoise: Optional[nn.Module] = None,
                 knee_pooling: bool = False, dropout_rate: float = 0.5,
                 image_size: Tuple[int, int] = (299, 299)):
        super().__init__()
        self.knee_pooling, self.dropout_rate = knee_pooling, dropout_rate
        self.denoise = denoise
        self.conv2d_1a = BasicConv2d(3, 32, (3, 3), stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, (3, 3))
        self.conv2d_2b = BasicConv2d(32, 64, (3, 3), padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, (1, 1))
        self.conv2d_4a = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        if knee_pooling:
            self.classif = _dense(2048, 2)
        else:
            h, w = (_feature_size(s) for s in image_size)
            self.classif = _dense(2048 * h * w, num_classes, std=0.1)

    def forward(self, x, defense: bool = False):
        x = x.permute(0, 3, 1, 2)
        if defense:
            if self.denoise is None:
                raise ValueError("defense=True requires a denoise module")
            x = self.denoise.nchw(x)
        x = self.conv2d_2b.nchw(self.conv2d_2a.nchw(self.conv2d_1a.nchw(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.conv2d_4a.nchw(self.conv2d_3b.nchw(x))
        x = F.max_pool2d(x, 3, stride=2)
        for blk in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                    self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                    self.Mixed_7c):
            x = blk.nchw(x)
        if self.knee_pooling:
            # global-average pool, max over batch, 2-class head (inception.py:414-418)
            x = x.mean(dim=(2, 3)).amax(dim=0, keepdim=True)
            return self.classif(x)
        if min(x.shape[-2:]) >= 5:
            x = F.avg_pool2d(x, 5)  # reference kernel_size=5
        else:  # flax's VALID pooling of a map under 5 px: no feature
            x = x[:, :, :0, :0]
        x = F.dropout(x, self.dropout_rate, training=self.training)
        return self.classif(_flatten_nhwc(x))


class inception_network(Inception3):
    """4-class wrapper (xray_inception_network.py:9-27). The reference
    branches num_classes on dataset_type but always constructs with 4; the
    default here preserves that."""

    def __init__(self, dataset_type: str = "x-ray", num_classes: int = 4,
                 image_size: Tuple[int, int] = (299, 299)):
        super().__init__(num_classes=num_classes, image_size=image_size)
        self.dataset_type = dataset_type


# ---------------------------------------------------------------------------
# losses + paired net (inception.py:433-509)
# ---------------------------------------------------------------------------

def denoise_loss(x, y, n: int, hard_mining: float = 0.0, norm: bool = False):
    """|x − y|^n / n with optional hard-example mining and normalization
    (inception.py:433-454)."""
    if not 0.0 <= hard_mining <= 1.0:
        raise ValueError(f"hard_mining must lie in [0, 1], got {hard_mining}")
    loss = torch.abs(x - y) ** n / n
    if hard_mining > 0:
        flat = loss.reshape(-1)
        loss, idcs = torch.topk(flat, int(flat.shape[0] * hard_mining))
        y = y.reshape(-1)[idcs]
    loss = loss.mean()
    if norm:
        loss = loss / (torch.abs(y) ** n).mean()
    return loss


def paired_loss(xs, ys, n: int, hard_mining: float = 0.0, norm: bool = False):
    """Per-feature-level list of denoise losses (inception.py:457-466)."""
    return [denoise_loss(x, y, n, hard_mining, norm) for x, y in zip(xs, ys)]


class Net(nn.Module):
    """Paired orig/adv forward (inception.py:469-493): clean logits, control
    (undefended adv) logits + loss, defended adv logits + loss."""

    def __init__(self, input_size: Tuple[int, int] = (299, 299), block=DenoiseConv,
                 fwd_out: Sequence[int] = (64, 128, 256, 256, 256),
                 num_fwd: Sequence[int] = (2, 3, 3, 3, 3),
                 back_out: Sequence[int] = (64, 128, 256, 256),
                 num_back: Sequence[int] = (2, 3, 3, 3),
                 n: int = 1, hard_mining: float = 0.0, loss_norm: bool = False,
                 num_classes: int = 1001):
        super().__init__()
        self.n, self.hard_mining, self.loss_norm = n, hard_mining, loss_norm
        denoise = Denoise(input_size[0], input_size[1], block=block, fwd_in=3, fwd_out=fwd_out,
                          num_fwd=num_fwd, back_out=back_out, num_back=num_back)
        self.net = Inception3(num_classes=num_classes, denoise=denoise,
                              image_size=tuple(input_size))

    def forward(self, orig_x, adv_x, requires_control: bool = True):
        orig_out = self.net(orig_x)
        if requires_control:
            control_out = self.net(adv_x)
            control_loss = paired_loss([control_out], [orig_out], self.n, self.hard_mining,
                                       self.loss_norm)
        adv_out = self.net(adv_x, defense=True)
        loss = paired_loss([adv_out], [orig_out], self.n, self.hard_mining, self.loss_norm)
        if not requires_control:
            return orig_out, adv_out, loss
        return orig_out, adv_out, loss, control_out, control_loss


def get_net(input_size, block=DenoiseConv, fwd_out=(64, 128, 256, 256, 256),
            num_fwd=(2, 3, 3, 3, 3), back_out=(64, 128, 256, 256),
            num_back=(2, 3, 3, 3), n=1, hard_mining=0.0, loss_norm=False,
            pretrained_path: Optional[str] = None, seed: int = 0) -> Net:
    """Build the paired defense net (inception.py:495-509), its weights
    drawn from ``seed`` (torch's global generator is left as it was).

    With ``pretrained_path`` (the reference's ``inceptionv3_state.pth``: a
    torch state dict in the reference's own naming, read with
    ``torch.load(weights_only=True)``, or the same arrays as ``.npz``) the
    inception weights are loaded into ``net.net`` with the JAX loader's
    strictness (``models.convert.load_inception_state_dict``); the Denoise
    front-end, which the file does not carry, keeps its initialized weights.
    Returns the net (JAX returns ``(net, variables)``; here the weights live
    in the module), in train mode as torch modules are built."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = Net(input_size=tuple(input_size), block=block, fwd_out=tuple(fwd_out),
                  num_fwd=tuple(num_fwd), back_out=tuple(back_out),
                  num_back=tuple(num_back), n=n, hard_mining=hard_mining,
                  loss_norm=loss_norm)
    if pretrained_path is not None:
        from shapley_vit_tpu_torch.models.convert import load_inception_state_dict

        if pretrained_path.endswith(".npz"):
            import numpy as np

            with np.load(pretrained_path) as z:
                sd = {k: z[k] for k in z.files}
        else:
            sd = torch.load(pretrained_path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
        load_inception_state_dict(net.net, sd)
    return net
