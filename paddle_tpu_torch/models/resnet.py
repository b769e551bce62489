"""ResNet family (inference), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/resnet.py``: ``BasicBlock`` (:15),
``BottleneckBlock`` (:42), ``ResNet`` (:73) and every factory
(``resnet18`` … ``resnext152_64x4d``, ``wide_resnet*``, :149-198), with
the JAX package's structure and attribute names (``conv1``, ``bn1``,
``layer1..4``, ``downsample`` as a two-module ``Sequential``, ``fc``), so
``state_dict`` names line up with the JAX model's (``params_from_jax``).

Semantics carried over from the Paddle layers:

* ``BatchNorm2D``: ``epsilon=1e-5``, parameters ``weight`` / ``bias`` and
  buffers ``_mean`` / ``_variance`` (``paddle_tpu/nn/modules_norm.py``).
  Only inference is ported: the forward uses the running statistics and
  raises in training mode (the train step is a later slice; there
  Paddle's ``momentum=0.9`` weighs the old running value, what torch
  calls ``momentum=0.1``).
* ``MaxPool2D(3, 2, 1)`` pads with −inf, as ``F.max_pool2d`` does;
  ``AdaptiveAvgPool2D((1, 1))``.
* ``Linear``'s weight is ``[in, out]`` (Paddle's layout), used as the
  transposed operand of ``F.linear`` (a view, no copy).
* Conv weights are OIHW; the default init is Paddle's
  ``Uniform(±sqrt(1 / fan_in))``, Linear's ``XavierNormal`` with a zero
  bias, BN ``weight = 1``, ``bias = 0``, ``_mean = 0``, ``_variance = 1``.

Factories take ``device=None`` (the card unless asked, see
``device.resolve_device``), ``dtype`` and a ``torch.Generator`` for the
init. ``params_from_jax`` (``llama.params_from_jax``) turns the JAX
model's ``state_dict()`` as numpy arrays into a state dict for
``load_state_dict``, in the same layouts and dtypes.
``analysis.fold_conv_bn`` turns an eval-mode model into the folded
inference model.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import params_from_jax

__all__ = ["BatchNorm2D", "Linear", "BasicBlock", "BottleneckBlock",
           "ResNet", "params_from_jax", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]


class BatchNorm2D(nn.Module):
    """Paddle's ``BatchNorm2D`` in inference: ``(x − _mean) ·
    rsqrt(_variance + epsilon) · weight + bias`` per channel of NCHW."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm2D is ported for inference only: call .eval() "
                "(training with batch statistics is not ported yet)")
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=False, eps=self.epsilon)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x, self.weight.t(), self.bias)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          groups: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, groups=groups, bias=False)


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
        _init_params(self, generator)
        self.to(device=dev, dtype=dtype)

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


@torch.no_grad()
def _init_params(model: nn.Module, generator) -> None:
    """Paddle's default init (module docstring), drawn from
    ``generator`` (torch's default generator when None)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            bound = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Linear):
            std = math.sqrt(2.0 / (m.in_features + m.out_features))
            m.weight.normal_(0.0, std, generator=generator)
            m.bias.zero_()


def _resnet(depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "no pretrained weights are shipped; load a local checkpoint "
            "with load_state_dict instead")
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
