"""ResNet family (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/resnet.py``: ``BasicBlock`` (:15),
``BottleneckBlock`` (:42), ``ResNet`` (:73) and every factory
(``resnet18`` … ``resnext152_64x4d``, ``wide_resnet*``, :149-198), with
the JAX package's structure and attribute names (``conv1``, ``bn1``,
``layer1..4``, ``downsample`` as a two-module ``Sequential``, ``fc``), so
``state_dict`` names line up with the JAX model's (``params_from_jax``).

The Paddle-semantics layers (``BatchNorm2D``, ``Linear``, the conv and its
default init) are those of ``models/_layers.py``; ``MaxPool2D(3, 2, 1)``
pads with −inf, as ``F.max_pool2d`` does; ``AdaptiveAvgPool2D((1, 1))``.

Factories take ``device=None`` (the card unless asked, see
``device.resolve_device``), ``dtype`` and a ``torch.Generator`` for the
init. ``params_from_jax`` (``llama.params_from_jax``) turns the JAX
model's ``state_dict()`` as numpy arrays into a state dict for
``load_state_dict``, in the same layouts and dtypes.
``analysis.fold_conv_bn`` turns an eval-mode model into the folded
inference model.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import BatchNorm2D, Linear, conv as _conv, place
from ._zoo import check_no_pretrained
from .llama import params_from_jax

__all__ = ["BatchNorm2D", "Linear", "BasicBlock", "BottleneckBlock",
           "ResNet", "params_from_jax", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1, "
                             "base_width=64")
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2D(planes)
        self.relu = nn.ReLU()
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2D(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = BatchNorm2D(width)
        self.conv2 = _conv(width, width, 3, stride, dilation, groups,
                           dilation)
        self.bn2 = BatchNorm2D(width)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = BatchNorm2D(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """``ResNet(block, depth, width=64, num_classes=1000, with_pool=True,
    groups=1)``; ``device`` / ``dtype`` / ``generator`` as the module
    docstring says."""

    _cfg = {18: (BasicBlock, [2, 2, 2, 2]),
            34: (BasicBlock, [3, 4, 6, 3]),
            50: (BottleneckBlock, [3, 4, 6, 3]),
            101: (BottleneckBlock, [3, 4, 23, 3]),
            152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, block=None, depth: int = 50, width: int = 64,
                 num_classes: int = 1000, with_pool: bool = True,
                 groups: int = 1, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        if block is None:
            block, layers = self._cfg[depth]
        else:
            _, layers = self._cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = _conv(3, self.inplanes, 7, 2, 3)
        self.bn1 = BatchNorm2D(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes)
        place(self, dev, dtype, generator)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                _conv(self.inplanes, planes * block.expansion, 1, stride),
                BatchNorm2D(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(depth, pretrained=False, **kwargs):
    check_no_pretrained(pretrained)
    return ResNet(depth=depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(101, pretrained, width=128, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnet(50, pretrained, groups=32, width=4, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnet(101, pretrained, groups=64, width=4, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnet(50, pretrained, groups=64, width=4, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnet(101, pretrained, groups=32, width=4, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnet(152, pretrained, groups=32, width=4, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnet(152, pretrained, groups=64, width=4, **kwargs)
