"""GoogLeNet, Inception v1 (inference and training), as a ``torch.nn.Module``.

Port of ``paddle_tpu/models/googlenet.py``: ``Inception`` (four branches
concatenated on channels), the two auxiliary heads and ``GoogLeNet``,
with the JAX package's attribute names. The forward returns ``(main,
aux1, aux2)`` as the JAX model does: in training each auxiliary head
returns its logits (through its ``Dropout(0.7)``: aux1's key is drawn
before aux2's, both before the head's ``Dropout(0.4)``), in eval
``None`` (their weights are still in the state dict). Every conv has a
bias and no BN: the conv-bn fold finds no site. Layers, init,
``device`` / ``dtype`` / ``generator``: ``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import Dropout, Linear, conv, place
from ._zoo import check_no_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class Inception(nn.Module):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(conv(in_c, c1, 1, bias=True), nn.ReLU())
        self.b2 = nn.Sequential(conv(in_c, c3r, 1, bias=True), nn.ReLU(),
                                conv(c3r, c3, 3, padding=1, bias=True),
                                nn.ReLU())
        self.b3 = nn.Sequential(conv(in_c, c5r, 1, bias=True), nn.ReLU(),
                                conv(c5r, c5, 5, padding=2, bias=True),
                                nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2d(3, stride=1, padding=1),
                                conv(in_c, proj, 1, bias=True), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                         1)


class _AuxHead(nn.Module):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2d((4, 4))
        self.conv = conv(in_c, 128, 1, bias=True)
        self.relu = nn.ReLU()
        self.fc1 = Linear(128 * 4 * 4, 1024)
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes)

    def forward(self, x):
        x = self.relu(self.conv(self.pool(x)))
        x = self.relu(self.fc1(x.flatten(1)))
        return self.fc2(self.drop(x))


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            conv(3, 64, 7, 2, 3, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            conv(64, 64, 1, bias=True), nn.ReLU(),
            conv(64, 192, 3, padding=1, bias=True), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2d(3, stride=2, padding=1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2d(3, stride=2, padding=1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
        self.aux1 = _AuxHead(512, num_classes if num_classes > 0 else 1000)
        self.aux2 = _AuxHead(528, num_classes if num_classes > 0 else 1000)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.drop = Dropout(0.4)
            self.fc = Linear(1024, num_classes)
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.inc3b(self.inc3a(self.stem(x)))
        x = self.inc4a(self.pool3(x))
        aux1 = self.aux1(x) if self.training else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.training else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return GoogLeNet(**kwargs)
