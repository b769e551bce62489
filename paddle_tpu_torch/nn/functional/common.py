"""``dropout``: ``paddle_tpu/nn/functional/common.py`` with its key
given, never drawn from a global generator.

The keep mask is ``jax.random.bernoulli(key, 1 - p, shape)``, which is
``uniform(key, shape) < 1 - p`` in f32, drawn by ``prng.uniform``: with
the same key the mask is the JAX mask bit for bit. The kept values are
divided by ``1 - p`` (a division, not a product with its reciprocal),
the rest are 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import prng

__all__ = ["dropout"]


def _divide(x, d: float):
    """``x / d`` with ``d`` in x's dtype, divided in f32 for bf16 / f16
    and rounded once, as XLA divides (a 0-d device tensor, so no backend
    turns it into a product with the reciprocal)."""
    div = torch.full((), d, dtype=x.dtype, device=x.device)
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() / div.float()).to(x.dtype)
    return x / div


def dropout(x, p: float = 0.5, *, key, training: bool = True):
    """Paddle's dropout (``mode="upscale_in_train"``, no ``axis``: the
    zoo's only form) of ``x`` with the threefry ``key`` ``[2]``."""
    if not training or p == 0.0:
        return x
    keep = prng.uniform(key.to(x.device), x.shape) < float(
        np.float32(1.0 - p))
    return torch.where(keep, _divide(x, 1.0 - p), 0.0).to(x.dtype)
