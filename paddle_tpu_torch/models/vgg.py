"""VGG family (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/vgg.py``: ``make_layers`` over the configs
'A' / 'B' / 'D' / 'E' (3x3 convs with bias, BN after each with
``batch_norm=True``), ``VGG`` and ``vgg11`` … ``vgg19``, attribute names
``features``, ``avgpool`` and ``classifier``. The convs keep their bias
with ``batch_norm=True``, so the conv-bn fold finds no ``conv → BN``
site there, as the JAX pass finds none (a bias add stands between the
conv and the BN). Layers, init, ``device`` / ``dtype`` / ``generator``:
``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import BatchNorm2D, Dropout, Linear, conv, place
from ._zoo import check_no_pretrained

__all__ = ["VGG", "make_layers", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm: bool = False) -> nn.Sequential:
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers.append(conv(in_c, v, 3, padding=1, bias=True))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_c = v
    return nn.Sequential(*layers)


class VGG(nn.Module):
    def __init__(self, features, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Linear(512 * 7 * 7, 4096), nn.ReLU(), Dropout(),
                Linear(4096, 4096), nn.ReLU(), Dropout(),
                Linear(4096, num_classes))
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return VGG(make_layers(_CFGS[cfg], batch_norm), **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
