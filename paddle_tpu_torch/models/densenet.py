"""DenseNet family (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/densenet.py``: ``DenseLayer`` (BN → relu →
1x1 bottleneck → BN → relu → 3x3, concatenated onto its input),
``Transition`` (BN → relu → 1x1 → 2x2 average pool), ``DenseNet`` and
``densenet121`` … ``densenet264``, with the JAX package's attribute
names. Under the conv-bn fold the stem and each layer's bottleneck
(``conv1 → bn2 → relu``, a 1x1 on the conv-epilogue kernel) are the
sites; the pre-activation BNs follow a concat or a pool, not a conv,
and stay. Layers, init, ``device`` / ``dtype`` / ``generator``:
``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import AvgPool2D, BatchNorm2D, Dropout, Linear, conv, place
from ._zoo import check_no_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFGS = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class DenseLayer(nn.Module):
    def __init__(self, in_c, growth_rate, bn_size, dropout: float = 0.0):
        super().__init__()
        self.bn1 = BatchNorm2D(in_c)
        self.conv1 = conv(in_c, bn_size * growth_rate, 1)
        self.bn2 = BatchNorm2D(bn_size * growth_rate)
        self.conv2 = conv(bn_size * growth_rate, growth_rate, 3, padding=1)
        self.relu = nn.ReLU()
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class Transition(nn.Module):
    def __init__(self, in_c, out_c):
        super().__init__()
        self.bn = BatchNorm2D(in_c)
        self.conv = conv(in_c, out_c, 1)
        self.relu = nn.ReLU()
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Module):
    def __init__(self, layers: int = 121, bn_size: int = 4,
                 dropout: float = 0.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        if layers not in _CFGS:
            raise ValueError(f"layers must be one of {sorted(_CFGS)}")
        dev = resolve_device(device)
        super().__init__()
        num_init, growth, block_cfg = _CFGS[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [conv(3, num_init, 7, 2, 3), BatchNorm2D(num_init),
                 nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1)]
        ch = num_init
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if bi != len(block_cfg) - 1:
                feats.append(Transition(ch, ch // 2))
                ch //= 2
        feats += [BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.classifier = Linear(ch, num_classes)
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _densenet(layers, pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kw):
    return _densenet(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _densenet(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _densenet(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _densenet(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _densenet(264, pretrained, **kw)
