"""Gate modules for ``MoELayer``.

Port of ``paddle_tpu/incubate/moe/gate.py`` (reference:
``incubate/distributed/models/moe/gate/`` naive_gate.py,
gshard_gate.py, switch_gate.py). Each gate maps token activations to
``(dispatch, combine, aux_loss)`` through ``functional.top_k_gating``.

``nn.Module``s: the router weight ``[d_model, E]`` is drawn from a
``torch.Generator`` inside ``XavierUniform``'s bound,
``sqrt(6 / (d_model + E))``; ``load_jax_state`` takes the JAX layer's
parameters as numpy (its ``state_dict`` names). ``dp_axis`` (passed by
``MoELayer`` under a mesh) makes the gating global over dp: the tokens
are this rank's rows, the capacity and the queues the global batch's,
and a random draw (GShard's second expert, Switch's jitter) the global
one's rows.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ... import prng
from . import functional as MF

__all__ = ["NaiveGate", "GShardGate", "SwitchGate", "xavier_uniform",
           "JaxStateMixin"]


def xavier_uniform(shape, generator: Optional[torch.Generator] = None,
                   device=None, dtype=torch.float32) -> nn.Parameter:
    """A ``[fan_in, fan_out]`` parameter uniform in ``XavierUniform``'s
    bound (the JAX ``create_parameter`` default of these layers)."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return nn.Parameter(((u * 2.0 - 1.0) * limit).to(dtype))


class JaxStateMixin:
    """``load_jax_state(named)``: copy the JAX layer's parameters
    (``{state_dict name: numpy array}``; the port's modules keep the JAX
    names) into this module's, in place."""

    @torch.no_grad()
    def load_jax_state(self, named) -> None:
        own = dict(self.named_parameters())
        if set(own) != set(named):
            raise KeyError(f"parameters {sorted(own)} vs JAX "
                           f"{sorted(named)}")
        for k, p in own.items():
            v = torch.from_numpy(np.array(named[k])).to(p.device, p.dtype)
            if v.shape != p.shape:
                raise ValueError(f"{k}: {tuple(v.shape)} vs {tuple(p.shape)}")
            p.copy_(v)


class NaiveGate(JaxStateMixin, nn.Module):
    """Plain learned top-k router, no randomness (naive_gate.py)."""

    top_k = 2
    second_policy = "all"

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.num_expert = num_expert * world_size
        self.top_k = topk
        self.weight = xavier_uniform((d_model, self.num_expert), generator,
                                     device)

    def forward(self, x, capacity_factor: float = 2.0, key=None,
                dp_axis=None):
        dp_g = MF._group(dp_axis)
        xs = x.reshape(-1, x.shape[-1])
        logits = xs.float() @ self.weight.float()
        cap = MF.default_capacity(xs.shape[0] * MF._n(dp_g),
                                  self.num_expert, self.top_k,
                                  capacity_factor)
        return MF.top_k_gating(logits, self.top_k, cap, key=key,
                               second_policy=self.second_policy,
                               dp_axis=dp_g)


class GShardGate(NaiveGate):
    """Top-2 with random second-expert routing (gshard_gate.py)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4), group=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(d_model, num_expert, world_size, topk, generator,
                         device)
        self.capacity = capacity
        self.second_policy = "random"


class SwitchGate(NaiveGate):
    """Top-1 switch-transformer router (switch_gate.py)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1, capacity=(1.2, 2.4),
                 group=None, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(d_model, num_expert, world_size, 1, generator,
                         device)
        self.switch_eps = switch_eps

    def forward(self, x, capacity_factor: float = 2.0, key=None,
                dp_axis=None):
        if key is not None:
            # switch jitter: multiplicative uniform noise on the inputs,
            # drawn over the global batch's shape
            dp_g = MF._group(dp_axis)
            shape = (x.shape[0] * MF._n(dp_g),) + tuple(x.shape[1:])
            noise = prng.uniform(key.to(x.device), shape,
                                 minval=1.0 - self.switch_eps,
                                 maxval=1.0 + self.switch_eps)
            x = x * MF._dp_rows(noise, dp_g).to(x.dtype)
        return super().forward(x, capacity_factor, key=None,
                               dp_axis=dp_axis)
