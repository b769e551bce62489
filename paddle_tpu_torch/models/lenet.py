"""LeNet-5 (inference and training), as a ``torch.nn.Module``.

Port of ``paddle_tpu/models/lenet.py``: 1 x 28 x 28 input, two conv /
relu / max-pool stages and three Linears (no activation between them,
as in the JAX model), attribute names ``features`` and ``fc``. Layers,
init, ``device`` / ``dtype`` / ``generator``: ``models/_layers.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ._layers import Linear, conv, place

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            conv(1, 6, 3, 1, 1, bias=True), nn.ReLU(), nn.MaxPool2d(2, 2),
            conv(6, 16, 5, 1, 0, bias=True), nn.ReLU(), nn.MaxPool2d(2, 2))
        if num_classes > 0:
            self.fc = nn.Sequential(Linear(400, 120), Linear(120, 84),
                                    Linear(84, num_classes))
        place(self, dev, dtype, generator)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
