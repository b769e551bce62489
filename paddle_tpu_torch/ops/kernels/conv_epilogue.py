"""Matmul + bias (+ relu) epilogue, the 1x1 convolution after the conv-bn
fold: the hand-written Hopper kernel's wrapper and its plain PyTorch
version.

Port of ``paddle_tpu/ops/pallas/conv_epilogue.py`` ``matmul_bias_act``
(:95; the TPU kernel ``_kernel`` :46 / ``_call`` :66). The kernel is
``csrc/conv_epilogue.cu``.

``matmul_bias_act(x2, w, bias, relu=True)`` -> ``[M, N]`` in x2's dtype:
``relu?(x2 [M, K] @ w [K, N] + bias [N])`` with the sum in f32 (f64 for
f64 inputs in the plain version), the f32 bias added to that sum, and one
rounding. This is the TPU kernel's arithmetic; the JAX package's fallback
for shapes its tiles do not divide adds the bias in x2's dtype instead.
Here there is no such fallback: the kernel takes every M, and K and N
multiples of 8, in float32 or bfloat16, with w in x2's dtype and bias
float32, both operands contiguous and 16-byte aligned, and raises on
anything else. The TPU kernel's tile choice (``tiles``, the autotune
lookup, ``default_tiles``) has no counterpart: the bf16 kernel picks its
tile width from N and K and cuts K into fixed chunks, never reading M,
so a row's bits do not depend on M (``csrc/conv_epilogue.cu``).

impl: ``"auto"`` — the kernel for CUDA tensors, the plain version for CPU
tensors; ``"kernel"`` — the kernel, raising on anything it cannot take;
``"reference"`` — the plain version on any device.
``matmul_bias_act.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["matmul_bias_act", "matmul_bias_act_reference"]

_KERNEL = "conv_epilogue"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IMPLS = ("auto", "kernel", "reference")


def matmul_bias_act_reference(x2, w, bias, relu: bool = True):
    """Plain ``matmul_bias_act``: the product and the bias in f32 (f64 for
    f64 inputs), relu, one cast to x2's dtype."""
    acc = torch.promote_types(x2.dtype, torch.float32)
    out = (x2.to(acc) @ w.to(acc)).add_(bias.to(acc))
    if relu:
        out = out.relu_()
    return out.to(x2.dtype)


def _lib():
    lib = _build.load(_KERNEL)
    fn = lib.paddle_matmul_bias_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x2, w, bias, relu: bool):
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"the conv-epilogue kernel takes CUDA tensors, got "
                         f"{dev}")
    for name, t in (("w", w), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"matmul_bias_act: {name} is on {t.device}, x2 "
                             f"on {dev}")
    if x2.dtype not in _DTYPE_CODE or w.dtype != x2.dtype:
        raise TypeError(f"matmul_bias_act: x2 and w must both be float32 or "
                        f"bfloat16, got {x2.dtype}/{w.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"matmul_bias_act: bias must be float32, got "
                        f"{bias.dtype}")
    M, K = x2.shape
    N = w.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"the conv-epilogue kernel takes K and N multiples "
                         f"of 8 (16-byte copies); got K={K}, N={N}")
    for name, t in (("x2", x2), ("w", w), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"matmul_bias_act: {name} must be contiguous")
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("matmul_bias_act: x2 and w must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().paddle_matmul_bias_act(
            x2.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            M, K, N, int(relu), _DTYPE_CODE[x2.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv-epilogue kernel launch failed (error "
                           f"{err}) for shape {(M, K, N)}")
    matmul_bias_act.launches += 1
    return out


def matmul_bias_act(x2, w, bias, relu: bool = True, impl: str = "auto"):
    """``relu?(x2 [M, K] @ w [K, N] + bias [N])`` in x2's dtype (module
    docstring)."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be auto|kernel|reference, got {impl!r}")
    if x2.dim() != 2 or w.dim() != 2 or w.shape[0] != x2.shape[1] or \
            bias.shape != (w.shape[1],):
        raise ValueError(f"x2 [M, K], w [K, N] and bias [N] expected, got "
                         f"{tuple(x2.shape)}, {tuple(w.shape)} and "
                         f"{tuple(bias.shape)}")
    if impl == "kernel" or (impl == "auto" and x2.is_cuda):
        return _launch(x2, w, bias, relu)
    return matmul_bias_act_reference(x2, w, bias, relu)


matmul_bias_act.launches = 0
