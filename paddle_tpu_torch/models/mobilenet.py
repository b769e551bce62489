"""MobileNet V1 / V2 / V3 (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/mobilenet.py``: ``_make_divisible``,
``ConvBNReLU`` (a ``Sequential`` of conv, BN and the activation, which
``shufflenetv2.py`` uses too), V1's depthwise-separable blocks, V2's
inverted residuals (ReLU6) and V3 Small / Large (squeeze-excitation,
hardswish, hardsigmoid), with the JAX package's attribute names and
constructor surface (``scale``, ``num_classes``, ``with_pool``).

Under the conv-bn fold every ``ConvBNReLU`` and every projection
(conv → BN with no activation) is a site; a site folds its activation
only when it is a relu, so ReLU6 and hardswish stay separate ops after
a site folded with ``relu=False``, as in the JAX graph. The pointwise
(1x1) sites go to the conv-epilogue kernel; the depthwise ones to the
grouped conv. The squeeze-excitation's 1x1 convs have a bias and no BN
and do not fold. Layers, init, ``device`` / ``dtype`` / ``generator``:
``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import (BatchNorm2D, Dropout, Hardsigmoid, Hardswish, Linear,
                      conv, place)
from ._zoo import zoo_factory

__all__ = ["MobileNetV1", "MobileNetV2", "MobileNetV3Small",
           "MobileNetV3Large", "mobilenet_v1", "mobilenet_v2",
           "mobilenet_v3_small", "mobilenet_v3_large"]

def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 act=nn.ReLU):
        padding = (kernel - 1) // 2
        layers = [conv(in_c, out_c, kernel, stride, padding, groups),
                  BatchNorm2D(out_c)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


# ------------------------------------------------------------------ V1
class DepthwiseSeparable(nn.Module):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.depthwise = ConvBNReLU(in_c, in_c, 3, stride, groups=in_c)
        self.pointwise = ConvBNReLU(in_c, out_c, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Module):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return int(ch * scale)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        blocks = [ConvBNReLU(3, c(32), 3, stride=2)]
        blocks += [DepthwiseSeparable(c(i), c(o), s) for i, o, s in cfg]
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes)
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


# ------------------------------------------------------------------ V2
class InvertedResidual(nn.Module):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_c * expand_ratio))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(in_c, hidden, 1, act=nn.ReLU6))
        layers += [
            ConvBNReLU(hidden, hidden, 3, stride, groups=hidden, act=nn.ReLU6),
            conv(hidden, out_c, 1),
            BatchNorm2D(out_c),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        last_c = _make_divisible(1280 * max(1.0, scale))
        blocks = [ConvBNReLU(3, in_c, 3, stride=2, act=nn.ReLU6)]
        for t, ch, n, s in cfg:
            out_c = _make_divisible(ch * scale)
            for i in range(n):
                blocks.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        blocks.append(ConvBNReLU(in_c, last_c, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(0.2), Linear(last_c, num_classes))
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


# ------------------------------------------------------------------ V3
class SqueezeExcitation(nn.Module):
    def __init__(self, channels, squeeze_factor=4):
        super().__init__()
        sq = _make_divisible(channels // squeeze_factor)
        self.pool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc1 = conv(channels, sq, 1, bias=True)
        self.fc2 = conv(sq, channels, 1, bias=True)
        self.relu = nn.ReLU()
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class V3Block(nn.Module):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNReLU(in_c, exp_c, 1, act=act))
        layers.append(ConvBNReLU(exp_c, exp_c, kernel, stride,
                                 groups=exp_c, act=act))
        if use_se:
            layers.append(SqueezeExcitation(exp_c))
        layers += [conv(exp_c, out_c, 1), BatchNorm2D(out_c)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_V3_SMALL = [
    # k, exp, out, se, act, stride
    (3, 16, 16, True, nn.ReLU, 2), (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]
_V3_LARGE = [
    (3, 16, 16, False, nn.ReLU, 1), (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1), (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1), (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]


class _MobileNetV3(nn.Module):
    def __init__(self, cfg, last_exp, scale=1.0, num_classes=1000,
                 with_pool=True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        in_c = _make_divisible(16 * scale)
        blocks = [ConvBNReLU(3, in_c, 3, stride=2, act=Hardswish)]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            blocks.append(V3Block(in_c, exp_c, out_c, k, s, se, act))
            in_c = out_c
        last_c = _make_divisible(last_exp * scale)
        blocks.append(ConvBNReLU(in_c, last_c, 1, act=Hardswish))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            head_c = 1024 if cfg is _V3_SMALL else 1280
            self.classifier = nn.Sequential(
                Linear(last_c, head_c), Hardswish(), Dropout(0.2),
                Linear(head_c, num_classes))
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_SMALL, 576, scale, num_classes, with_pool, **kw)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, **kw):
        super().__init__(_V3_LARGE, 960, scale, num_classes, with_pool, **kw)


mobilenet_v1 = zoo_factory(MobileNetV1, "mobilenet_v1")
mobilenet_v2 = zoo_factory(MobileNetV2, "mobilenet_v2")
mobilenet_v3_small = zoo_factory(MobileNetV3Small, "mobilenet_v3_small")
mobilenet_v3_large = zoo_factory(MobileNetV3Large, "mobilenet_v3_large")
