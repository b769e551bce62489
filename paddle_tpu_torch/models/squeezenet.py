"""SqueezeNet 1.0 / 1.1 (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/squeezenet.py``: ``Fire`` (squeeze 1x1 ->
expand 1x1 and 3x3, concatenated on channels), ``SqueezeNet`` and its
two factories, attribute names ``features``, ``classifier`` and
``pool``. The max-pools round their output size down, as the JAX
layers do. Every conv has a bias and no BN: the conv-bn fold finds no
site. Layers, init, ``device`` / ``dtype`` / ``generator``:
``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import Dropout, conv, place
from ._zoo import check_no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(nn.Module):
    def __init__(self, in_c, squeeze_c, expand1x1_c, expand3x3_c):
        super().__init__()
        self.squeeze = conv(in_c, squeeze_c, 1, bias=True)
        self.expand1x1 = conv(squeeze_c, expand1x1_c, 1, bias=True)
        self.expand3x3 = conv(squeeze_c, expand3x3_c, 3, padding=1,
                              bias=True)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1x1(x)),
                          self.relu(self.expand3x3(x))], 1)


class SqueezeNet(nn.Module):
    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                conv(3, 96, 7, 2, bias=True), nn.ReLU(),
                nn.MaxPool2d(3, stride=2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128), nn.MaxPool2d(3, stride=2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2d(3, stride=2), Fire(512, 64, 256, 256))
        elif version == "1.1":
            self.features = nn.Sequential(
                conv(3, 64, 3, 2, bias=True), nn.ReLU(),
                nn.MaxPool2d(3, stride=2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2d(3, stride=2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2d(3, stride=2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256))
        else:
            raise ValueError(f"unsupported version {version!r}")
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(0.5), conv(512, num_classes, 1, bias=True),
                nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
