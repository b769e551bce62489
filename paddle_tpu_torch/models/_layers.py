"""Paddle-semantics layers of the vision models, as ``torch.nn.Module``s.

The JAX package's layers (``paddle_tpu/nn/modules_norm.py``,
``modules_basic.py``, ``modules_conv.py``) with their attribute names,
constants and defaults, where torch's built-in differs or names things
otherwise:

* ``BatchNorm2D``: ``momentum = 0.9``, ``epsilon=1e-5``, parameters
  ``weight`` / ``bias`` and buffers ``_mean`` / ``_variance``. In eval
  the running statistics normalise; in training the batch's, as
  ``batch_norm_train`` says, and the running statistics become
  ``old · momentum + (1 − momentum) · batch`` with the batch's biased
  variance (Paddle's ``momentum`` weighs the old value; torch's
  ``F.batch_norm`` weighs the new one and keeps the unbiased variance,
  so it does not update them here).
* ``Linear``: ``weight`` is ``[in, out]`` (Paddle's layout), used as the
  transposed operand of ``F.linear`` (a view, no copy); an op named
  ``linear`` for ``auto_cast``; input and parameters of different dtypes
  (an O2-decorated layer fed f32) promote, as ``jnp`` does.
* ``conv`` builds a ``Conv2D``: ``nn.Conv2d`` with OIHW weights, ``bias``
  as Paddle's ``bias_attr`` (a bias unless False), an op named
  ``conv2d`` for ``auto_cast``; ``stem_s2d`` (set by
  ``analysis.prepare_training``) runs it as the space-to-depth stem.
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
* ``Dropout``: the identity in eval; in training Paddle's dropout
  (``nn.functional.dropout``) with one key a call from its
  ``generator`` (a ``core.Generator``, which ``vision.train.
  make_train_step`` sets), so the masks follow the module call order
  as the JAX package's ``gen.next_key()`` draws do.

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

from ..amp import amp_cast
from ..nn.functional.common import dropout as _dropout
from ..ops.fused import conv_epilogue as _fused

__all__ = ["BatchNorm2D", "batch_norm_train", "Linear", "Conv2D", "conv",
           "Hardsigmoid", "Hardswish", "AvgPool2D", "Dropout", "init_params",
           "place"]


def batch_norm_train(x, weight, bias, epsilon: float = 1e-5):
    """``paddle_tpu/nn/functional/norm.py`` ``_batch_norm_train`` on NCHW
    (any memory format): returns ``(out, mean, var)``.

    The statistics are over (N, H, W) in f32 (in x's dtype when wider),
    the variance biased (``jnp.var``).
    ``out = round_to_x_dtype((x − mean) · rsqrt(var + ε)) · weight +
    bias``: the normalised value is rounded to x's dtype before the f32
    affine, so a bf16 input gives an f32 output, as ``jnp`` promotes.
    ``F.batch_norm`` (training, no affine) computes exactly that
    normalised value, rounded once to x's dtype, and its backward; the
    affine is one ``addcmul``. The statistics are the ones that same
    call computes: it is given zeroed running buffers and momentum 1, so
    they come back holding the batch's mean and unbiased variance, which
    is scaled by (n − 1) / n to the biased one (no second pass over x).
    The buffers are f32 (x's dtype when wider), which also keeps the
    normalisation in f32 on the CPU: given no f32 buffer, the CPU kernel
    keeps a bf16 input's mean and rsqrt in bf16."""
    c = x.shape[1]
    n = x.numel() // c
    mean, var = x.new_zeros((2, c),
                            dtype=torch.promote_types(x.dtype, torch.float32))
    norm = F.batch_norm(x, mean, var, None, None, True, 1.0, epsilon)
    shape = (1, -1, 1, 1)
    # out of place: the call's backward keeps the buffers it was given
    return torch.addcmul(bias.view(shape), norm, weight.view(shape)), \
        mean, var * ((n - 1) / n)


class BatchNorm2D(nn.Module):
    """Paddle's ``BatchNorm2D`` on NCHW: with the running statistics
    ``(x − _mean) · rsqrt(_variance + epsilon) · weight + bias``; in
    training ``batch_norm_train`` and the running update (module
    docstring), in place without a gradient."""

    momentum = 0.9

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            # a bf16 input meets f32 statistics in f32, as jnp promotes
            x = x.to(torch.promote_types(x.dtype, self._mean.dtype))
            return F.batch_norm(x, self._mean, self._variance, self.weight,
                                self.bias, training=False, eps=self.epsilon)
        out, mean, var = batch_norm_train(x, self.weight, self.bias,
                                          self.epsilon)
        m = self.momentum
        with torch.no_grad():
            for buf, batch in ((self._mean, mean), (self._variance, var)):
                buf.mul_(m).add_(batch.to(buf.dtype) * (1 - m))
        return out


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        # mixed dtypes (an O2 layer fed f32) promote, as jnp does; no
        # branch on the dtypes, so torch.fx traces the layer (the fold)
        dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                                 b.dtype)
        return F.linear(x.to(dt), w.t().to(dt), b.to(dt))


class Conv2D(nn.Conv2d):
    """``nn.Conv2d`` as Paddle's ``conv2d`` op (module docstring). With
    ``stem_s2d`` set, an input of even height and width runs through
    ``stem_s2d_conv_nchw``: the same taps as the 7x7 / stride-2 / pad-3
    conv, as a dense 4x4 / stride-1 conv over the space-to-depth input,
    differentiable in x and in the same ``weight``."""

    stem_s2d = False

    def forward(self, x):
        x, w, b = amp_cast("conv2d", x, self.weight, self.bias)
        if self.stem_s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            out = _fused.stem_s2d_conv_nchw(x, w)
            return out if b is None else out + b.view(1, -1, 1, 1)
        return self._conv_forward(x, w, b)


def conv(cin: int, cout: int, k, stride=1, padding=0, groups: int = 1,
         dilation=1, bias: bool = False) -> Conv2D:
    """Paddle's ``Conv2D(cin, cout, k, stride, padding, dilation, groups,
    bias_attr)`` as a ``Conv2D`` (``k``, ``stride``, ``padding`` an int
    or an (h, w) pair)."""
    return Conv2D(cin, cout, k, stride=stride, padding=padding,
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
    """Paddle's ``Dropout(p)``; ``generator`` (a ``core.Generator``) gives
    each training call its key."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "Dropout in training draws its mask from a key stream: "
                "set module.generator to a core.Generator (make_train_step "
                "does)")
        return _dropout(x, self.p, key=self.generator.next_key())


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
