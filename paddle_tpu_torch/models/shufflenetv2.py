"""ShuffleNetV2 family (inference and training), as ``torch.nn.Module``s.

Port of ``paddle_tpu/models/shufflenetv2.py``: ``channel_shuffle``, the
stride-1 ``ShuffleUnit`` (split the channels, transform one half,
concatenate, shuffle) and the stride-2 ``ShuffleDownUnit``, every scale
of ``_STAGE_OUT`` and the swish variant, with the JAX package's
attribute names. ``ConvBNReLU`` is MobileNet's.

``channel_shuffle`` shuffles within each pixel's channels and returns
channels-last memory, so the 1x1 sites after it read their rows without
a copy; it is an ``fx`` leaf, a function the
conv-bn fold traces as one call. A ``ShuffleUnit``'s second half
(``x[:, c:]``) is a strided view of a channels-last tensor: a 1x1 site
on the kernel route copies it (``matmul_bias_act.input_copies``).

Branch widths that are not multiples of 8 (``× 0.25``: 12; ``× 1.0``:
58 and 116; ``× 2.0``: 122) give 1x1 sites that the conv-epilogue
kernel cannot take; the fold routes them onto the conv route by their
shapes (``analysis/rewrite_conv.py``). Layers, init, ``device`` /
``dtype`` / ``generator``: ``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.fx
from torch import nn

from ..device import resolve_device
from ._layers import Linear, place
from ._zoo import zoo_factory
from .mobilenet import ConvBNReLU

__all__ = ["ShuffleNetV2", "channel_shuffle", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_33", "shufflenet_v2_x0_5", "shufflenet_v2_x1_0",
           "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish"]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048],
}
_STAGE_REPEATS = [4, 8, 4]


def channel_shuffle(x, groups: int):
    """``[N, C, H, W]``: channel ``g · C/groups + j`` goes to
    ``j · groups + g``, as a shuffle within each pixel's channel row: the
    output is channels-last (a channels-last input is read in place)."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups)
    return y.transpose(3, 4).reshape(n, h, w, c).permute(0, 3, 1, 2)


torch.fx.wrap("channel_shuffle")


class ShuffleUnit(nn.Module):
    """stride-1 unit: split channels, transform one half, shuffle."""

    def __init__(self, channels, act):
        super().__init__()
        c = channels // 2
        self.branch = nn.Sequential(
            ConvBNReLU(c, c, 1, act=act),
            ConvBNReLU(c, c, 3, groups=c, act=None),
            ConvBNReLU(c, c, 1, act=act))
        self._c = c

    def forward(self, x):
        x1, x2 = x[:, :self._c], x[:, self._c:]
        return channel_shuffle(torch.cat([x1, self.branch(x2)], 1), 2)


class ShuffleDownUnit(nn.Module):
    """stride-2 unit: both branches transform, spatial halved."""

    def __init__(self, in_c, out_c, act):
        super().__init__()
        c = out_c // 2
        self.branch1 = nn.Sequential(
            ConvBNReLU(in_c, in_c, 3, stride=2, groups=in_c, act=None),
            ConvBNReLU(in_c, c, 1, act=act))
        self.branch2 = nn.Sequential(
            ConvBNReLU(in_c, c, 1, act=act),
            ConvBNReLU(c, c, 3, stride=2, groups=c, act=None),
            ConvBNReLU(c, c, 1, act=act))

    def forward(self, x):
        return channel_shuffle(
            torch.cat([self.branch1(x), self.branch2(x)], 1), 2)


class ShuffleNetV2(nn.Module):
    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        dev = resolve_device(device)
        super().__init__()
        act_layer = nn.SiLU if act == "swish" else nn.ReLU
        outs = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNReLU(3, outs[0], 3, stride=2, act=act_layer)
        self.pool1 = nn.MaxPool2d(3, stride=2, padding=1)
        stages = []
        in_c = outs[0]
        for si, reps in enumerate(_STAGE_REPEATS):
            out_c = outs[si + 1]
            stages.append(ShuffleDownUnit(in_c, out_c, act_layer))
            stages += [ShuffleUnit(out_c, act_layer) for _ in range(reps - 1)]
            in_c = out_c
        self.stages = nn.Sequential(*stages)
        self.conv_last = ConvBNReLU(in_c, outs[-1], 1, act=act_layer)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2d((1, 1))
        if num_classes > 0:
            self.fc = Linear(outs[-1], num_classes)
        place(self, dev, dtype, generator)

    def forward(self, x):
        x = self.conv_last(self.stages(self.pool1(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


shufflenet_v2_x0_25 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x0_25",
                                  scale=0.25)
shufflenet_v2_x0_33 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x0_33",
                                  scale=0.33)
shufflenet_v2_x0_5 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x0_5",
                                 scale=0.5)
shufflenet_v2_x1_0 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x1_0",
                                 scale=1.0)
shufflenet_v2_x1_5 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x1_5",
                                 scale=1.5)
shufflenet_v2_x2_0 = zoo_factory(ShuffleNetV2, "shufflenet_v2_x2_0",
                                 scale=2.0)
shufflenet_v2_swish = zoo_factory(ShuffleNetV2, "shufflenet_v2_swish",
                                  scale=1.0, act="swish")
