"""Weight-only int8 matmul operand of the decode path.

Port of ``paddle_tpu/ops/fused/int8_matmul.py``: ``Int8Weight`` holds
``q`` (int8 ``[..., in, out]``) and ``scale`` (f32 ``[..., out]``), one
symmetric scale per (leading..., out) channel, ``w ≈ q * scale``. Model
code calls ``w.dequant_matmul(x)``; ``w[i]`` indexes both leaves, so a
layer-stacked weight slices like a dense one.

The product has one arithmetic whatever runs it, the Pallas kernel's:
the sum in f32, times the scale, one rounding to x's dtype
(``ops/kernels/int8_matmul``). The JAX package's default ``jnp`` path
rounds the product before the scale; in f32 the two agree to rounding.
"""
from __future__ import annotations

import torch

# x [..., in] @ dequant(q, scale) in x's dtype; impl "auto" (the kernel
# for CUDA tensors, the plain version for CPU tensors), "kernel" or
# "reference"
from ..kernels.int8_matmul import int8_matmul as int8_weight_matmul

__all__ = ["Int8Weight", "quantize_weight_per_channel",
           "int8_weight_matmul"]


def _quantize(w):
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_weight_per_channel(w):
    """Symmetric per-output-channel int8 quantization of a ``[..., in,
    out]`` weight: ``(q int8 [..., in, out], scale f32 [..., out])``,
    scale = max(absmax, 1e-8) / 127 and q = round-half-to-even(w /
    scale) clipped to ±127 — the JAX package's bits. Stacked leading
    axes quantize one matrix at a time, so at most one matrix is held
    in f32 beside the result."""
    if w.dim() == 2:
        return _quantize(w)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((flat.shape[0], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for i in range(flat.shape[0]):
        q[i], scale[i] = _quantize(flat[i])
    return q.reshape(w.shape), scale.reshape(*lead, w.shape[-1])


class Int8Weight:
    """A weight-only-quantized matmul operand: ``q`` int8 ``[..., in,
    out]`` and ``scale`` f32 ``[..., out]``."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def ndim(self):
        return self.q.dim()

    @property
    def device(self):
        return self.q.device

    def __getitem__(self, idx) -> "Int8Weight":
        return type(self)(self.q[idx], self.scale[idx])

    def __repr__(self):
        return (f"Int8Weight(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")

    @classmethod
    def quantize(cls, w) -> "Int8Weight":
        return cls(*quantize_weight_per_channel(w))

    def dequant(self, dtype=torch.bfloat16):
        """Dense ``[..., in, out]`` approximation in ``dtype``."""
        # int8 * f32 promotes to f32: the same bits as q.float() * scale,
        # with no f32 copy of q
        return torch.mul(self.q, self.scale[..., None, :]).to(dtype)

    def dequant_matmul(self, x, impl: str = "auto"):
        return int8_weight_matmul(x, self.q, self.scale, impl=impl)
