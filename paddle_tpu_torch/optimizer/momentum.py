"""SGD with momentum: ``paddle_tpu/optimizer/optimizer.py`` ``Momentum``
(:213-233).

Per parameter ``w`` with gradient ``g`` and velocity ``v`` (zeros at
first, in w's dtype and memory format): ``v ← μ·v + g``, then ``w ← w −
lr·v``. Each product is rounded before its sum, as the JAX package
writes it; this is also ``optax.sgd(lr, momentum=μ)`` (``trace = g +
μ·trace``, ``w + (−lr·trace)``), bit for bit where XLA does not
contract a product and a sum into one fused multiply-add. Nesterov and
weight decay are not on the vision step's path and are not ported.

``step()`` updates every parameter that has a ``.grad`` in place, one
tensor at a time, and frees its gradient.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import torch

__all__ = ["Momentum"]


class Momentum:
    def __init__(self, learning_rate: float, momentum: float,
                 parameters: Iterable[torch.Tensor]):
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.parameters: List[torch.Tensor] = list(parameters)
        self.velocity: List[Optional[torch.Tensor]] = [None] * len(
            self.parameters)

    @torch.no_grad()
    def step(self) -> None:
        lr, mu = self.learning_rate, self.momentum
        for i, p in enumerate(self.parameters):
            g = p.grad
            if g is None:
                continue
            p.grad = None
            v = self.velocity[i]
            if v is None:
                v = self.velocity[i] = torch.zeros_like(p)
            v.mul_(mu).add_(g.to(p.dtype))
            p.sub_(v * lr)
