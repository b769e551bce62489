"""Inception v3 (inference and training), as a ``torch.nn.Module``.

Port of ``paddle_tpu/models/inceptionv3.py``: ``BasicConv2D`` (a
``Sequential`` of conv, BN and relu), ``InceptionA`` … ``InceptionE``
with the factorised 1x7 / 7x1 and 1x3 / 3x1 convs, and ``InceptionV3``
(299 x 299 at full size; inputs of 75 x 75 and up), with the JAX
package's attribute names. Under the conv-bn fold every
``BasicConv2D`` is a site with its relu; the 1x1 ones (every branch's
head) go to the conv-epilogue kernel and read the block's concatenated
input, which stays channels-last. Layers, init, ``device`` / ``dtype``
/ ``generator``: ``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import AvgPool2D, BatchNorm2D, Dropout, Linear, conv, place
from ._zoo import check_no_pretrained

__all__ = ["InceptionV3", "inception_v3"]


class BasicConv2D(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0):
        super().__init__(conv(in_c, out_c, kernel, stride, padding),
                         BatchNorm2D(out_c), nn.ReLU())


class InceptionA(nn.Module):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = BasicConv2D(in_c, 64, 1)
        self.b5 = nn.Sequential(BasicConv2D(in_c, 48, 1),
                                BasicConv2D(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(BasicConv2D(in_c, 64, 1),
                                BasicConv2D(64, 96, 3, padding=1),
                                BasicConv2D(96, 96, 3, padding=1))
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1),
                                BasicConv2D(in_c, pool_features, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                         1)


class InceptionB(nn.Module):
    """grid reduction 35 -> 17"""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = BasicConv2D(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(BasicConv2D(in_c, 64, 1),
                                 BasicConv2D(64, 96, 3, padding=1),
                                 BasicConv2D(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = BasicConv2D(in_c, 192, 1)
        self.b7 = nn.Sequential(
            BasicConv2D(in_c, c7, 1),
            BasicConv2D(c7, c7, (1, 7), padding=(0, 3)),
            BasicConv2D(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            BasicConv2D(in_c, c7, 1),
            BasicConv2D(c7, c7, (7, 1), padding=(3, 0)),
            BasicConv2D(c7, c7, (1, 7), padding=(0, 3)),
            BasicConv2D(c7, c7, (7, 1), padding=(3, 0)),
            BasicConv2D(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1),
                                BasicConv2D(in_c, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                         1)


class InceptionD(nn.Module):
    """grid reduction 17 -> 8"""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(BasicConv2D(in_c, 192, 1),
                                BasicConv2D(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            BasicConv2D(in_c, 192, 1),
            BasicConv2D(192, 192, (1, 7), padding=(0, 3)),
            BasicConv2D(192, 192, (7, 1), padding=(3, 0)),
            BasicConv2D(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = BasicConv2D(in_c, 320, 1)
        self.b3_1 = BasicConv2D(in_c, 384, 1)
        self.b3_2a = BasicConv2D(384, 384, (1, 3), padding=(0, 1))
        self.b3_2b = BasicConv2D(384, 384, (3, 1), padding=(1, 0))
        self.bd_1 = nn.Sequential(BasicConv2D(in_c, 448, 1),
                                  BasicConv2D(448, 384, 3, padding=1))
        self.bd_2a = BasicConv2D(384, 384, (1, 3), padding=(0, 1))
        self.bd_2b = BasicConv2D(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(AvgPool2D(3, stride=1, padding=1),
                                BasicConv2D(in_c, 192, 1))

    def forward(self, x):
        b3 = self.b3_1(x)
        bd = self.bd_1(x)
        return torch.cat([self.b1(x), self.b3_2a(b3), self.b3_2b(b3),
                          self.bd_2a(bd), self.bd_2b(bd), self.bp(x)], 1)


class InceptionV3(nn.Module):
    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            BasicConv2D(3, 32, 3, stride=2),
            BasicConv2D(32, 32, 3),
            BasicConv2D(32, 64, 3, padding=1),
            nn.MaxPool2d(3, stride=2),
            BasicConv2D(64, 80, 1),
            BasicConv2D(80, 192, 3),
            nn.MaxPool2d(3, stride=2))
        self.blocks = nn.Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160),
            InceptionC(768, 160), InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.drop = Dropout(0.2)
            self.fc = Linear(2048, num_classes)
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return InceptionV3(**kwargs)
