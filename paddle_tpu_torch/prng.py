"""Counter-based PRNG: the threefry-2x32 draws of the JAX package.

The JAX package draws its sampling noise through ``jax.random`` with
the threefry-2x32 hash in its partitionable layout
(``jax_threefry_partitionable``, on by default). These are the same
functions on int64 tensors that hold uint32 values, every add and shift
masked back to 32 bits, so a key, a ``fold_in``, a ``split`` and the
bits drawn from them equal ``jax.random``'s bit for bit. ``uint32``
tensors are not used: their shifts and adds are missing on some
backends. Integer ops are exact on every device, so the bits do not
depend on where they run; the floats made from them (``uniform``,
``gumbel``) round as any f32 log does.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of a
raw JAX key. Every function runs on the device of its inputs and keeps
no state: no ``torch.Generator`` is involved.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "threefry2x32", "fold_in", "split", "bits", "uniform",
           "gumbel", "categorical"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def key(seed: int, device="cpu") -> torch.Tensor:
    """The raw key of ``jax.random.PRNGKey(seed)`` with 64-bit mode off:
    ``(0, seed & 0xffffffff)``, the mask taken on the Python int (so
    negative and wider seeds wrap as JAX wraps them)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash (20 rounds) of the counter pair ``(x0,
    x1)`` under the key ``(k0, k1)``; int64 tensors of uint32 values
    that broadcast together. Returns the output pair."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(keys, idx) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``keys [..., 2]`` with ``idx
    [...]`` (any int, taken as uint32) -> keys ``[..., 2]``."""
    idx = torch.as_tensor(idx, device=keys.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(idx), idx)
    return torch.stack([y0, y1], dim=-1)


def split(k, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)`` in the partitionable layout: key ``i``
    is the hash of the counter ``(0, i)``. Returns keys ``[n, 2]``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def bits(keys, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` for each key of ``keys
    [..., 2]``: the hash of the counters ``(i >> 32, i & mask)`` over
    the flattened ``shape``, its two words xor-ed. Returns int64 of
    uint32 values, ``[..., *shape]``."""
    shape = tuple(int(s) for s in shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(keys, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to ``[minval, maxval)``. The bounds
    and their difference are f32 values; the scale and the shift round
    once, as the fused multiply-add XLA makes of them."""
    b = bits(keys, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    # f * span is exact in f64 (two 24-bit significands)
    u = (f.double() * span + float(lo)).float()
    return torch.clamp(u, min=float(lo))


def gumbel(keys, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (f32, mode "low"): ``-log(-log(u))`` with
    ``u`` uniform over ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(keys, shape, _F32_TINY, 1.0)))


def categorical(keys, logits) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)``: the argmax of
    ``logits`` plus Gumbel noise. One key ``[2]`` draws the noise over
    the whole of ``logits`` (as ``categorical`` on a batch); keys
    ``[B, 2]`` draw each row's ``[V]`` noise from its own key (as a
    ``vmap`` over rows). Returns int64 indices."""
    g = gumbel(keys, logits.shape[keys.dim() - 1:])
    return torch.argmax(logits + g, dim=-1)
