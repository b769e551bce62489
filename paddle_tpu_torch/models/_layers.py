"""Paddle-semantics layers of the vision models, as ``torch.nn.Module``s.

The JAX package's layers (``paddle_tpu/nn/modules_norm.py``,
``modules_basic.py``, ``modules_conv.py``) with their attribute names,
constants and defaults, where torch's built-in differs or names things
otherwise:

* ``BatchNorm2D``: ``epsilon=1e-5``, parameters ``weight`` / ``bias`` and
  buffers ``_mean`` / ``_variance``. Only inference is ported: the
  forward uses the running statistics and raises in training mode (the
  train step is a later slice; there Paddle's ``momentum=0.9`` weighs the
  old running value, what torch calls ``momentum=0.1``).
* ``Linear``: ``weight`` is ``[in, out]`` (Paddle's layout), used as the
  transposed operand of ``F.linear`` (a view, no copy).
* ``conv``: ``nn.Conv2d`` with OIHW weights; ``bias`` as Paddle's
  ``bias_attr`` (a bias unless False).
* ``Hardsigmoid`` (``clip(x · (1/6) + 0.5, 0, 1)``,
  ``paddle_tpu/nn/functional/activation.py:89``) and ``Hardswish``
  (``x · clip(x / 6 + 0.5, 0, 1)``, :94), with the JAX package's
  constants and operation order.
* ``AvgPool2D``: Paddle's ``(kernel_size, stride=None, padding=0)`` with
  ``stride`` defaulting to the kernel size, excluding the padding from
  the count (Paddle's ``exclusive=True``). Max pooling, adaptive
  average pooling, ReLU6 and swish are torch's ``nn.MaxPool2d``,
  ``nn.AdaptiveAvgPool2d``, ``nn.ReLU6`` and ``nn.SiLU``, which compute
  what the JAX layers compute (no parameters, so no ``state_dict`` key
  depends on them).
* ``Dropout``: the identity in eval; raises in training (only inference
  is ported).

``init_params`` draws Paddle's default init: conv weights
``Uniform(±sqrt(1 / fan_in))`` and zero conv biases, Linear's
``XavierNormal`` with a zero bias; BN keeps ``weight = 1``, ``bias = 0``,
``_mean = 0``, ``_variance = 1``. ``place`` runs it from a
``torch.Generator`` (torch's default generator when None) and moves the
model to its device and dtype: every model of the zoo ends its
constructor with it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm2D", "Linear", "conv", "Hardsigmoid", "Hardswish",
           "AvgPool2D", "Dropout", "init_params", "place"]


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


def conv(cin: int, cout: int, k, stride=1, padding=0, groups: int = 1,
         dilation=1, bias: bool = False) -> nn.Conv2d:
    """Paddle's ``Conv2D(cin, cout, k, stride, padding, dilation, groups,
    bias_attr)`` as ``nn.Conv2d`` (``k``, ``stride``, ``padding`` an int
    or an (h, w) pair)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, groups=groups, bias=bias)


class Hardsigmoid(nn.Module):
    """``clip(x · (1/6) + 0.5, 0, 1)``."""

    def forward(self, x):
        return torch.clamp(x * (1.0 / 6) + 0.5, 0.0, 1.0)


class Hardswish(nn.Module):
    def forward(self, x):
        return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = kernel_size if stride is None else stride
        self.padding = padding

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            count_include_pad=False)


class Dropout(nn.Module):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "Dropout is ported for inference only: call .eval()")
        return x


@torch.no_grad()
def init_params(model: nn.Module, generator) -> None:
    """Paddle's default init (module docstring), drawn from
    ``generator`` (torch's default generator when None)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
            bound = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, Linear):
            std = math.sqrt(2.0 / (m.in_features + m.out_features))
            m.weight.normal_(0.0, std, generator=generator)
            m.bias.zero_()


def place(model: nn.Module, device: torch.device, dtype: torch.dtype,
          generator: Optional[torch.Generator]) -> None:
    """Initialise ``model``'s parameters (``init_params``) and move it to
    ``device`` (already resolved) and ``dtype``."""
    init_params(model, generator)
    model.to(device=device, dtype=dtype)
