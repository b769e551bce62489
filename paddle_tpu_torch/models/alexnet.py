"""AlexNet (inference and training), as a ``torch.nn.Module``.

Port of ``paddle_tpu/models/alexnet.py``: 5 convs with bias and 3
Linears, no LRN, attribute names ``features``, ``avgpool`` and
``classifier``. Layers, init, ``device`` / ``dtype`` / ``generator``:
``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import Dropout, Linear, conv, place
from ._zoo import check_no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 1000, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            conv(3, 64, 11, 4, 2, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            conv(64, 192, 5, 1, 2, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, stride=2),
            conv(192, 384, 3, 1, 1, bias=True), nn.ReLU(),
            conv(384, 256, 3, 1, 1, bias=True), nn.ReLU(),
            conv(256, 256, 3, 1, 1, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, stride=2))
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                Dropout(), Linear(256 * 6 * 6, 4096), nn.ReLU(),
                Dropout(), Linear(4096, 4096), nn.ReLU(),
                Linear(4096, num_classes))
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return AlexNet(**kwargs)
