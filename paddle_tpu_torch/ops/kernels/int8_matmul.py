"""Weight-only int8 matmul: the hand-written Hopper kernel's wrapper and
its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/int8_matmul.py`` (``_kernel`` :48,
entry ``int8_matmul_pallas`` :84). Contract, the Pallas kernel's
arithmetic:

    out[m, n] = round_to_x_dtype((sum_k x[m, k] * float(q[k, n])) * scale[n])

with the sum in f32 (f64 for f64 inputs in the plain version). x is
``[..., K]`` bf16 or f32; q int8 ``[K, N]`` in the JAX layout; scale f32
``[N]``. Any M (the product of x's leading dims) >= 1.

The kernel (``csrc/int8_matmul.cu``: the weight widened in registers
as the A operand of ``wgmma``, x by TMA as B, on the roles and ring of
``csrc/gemm_sm90.cuh``) takes K a multiple of 8 and N a multiple of 16
and raises on anything else: unlike the JAX entry it never drops
quietly to a plain formulation for a shape it cannot tile. Its rows are
batch invariant: a row's output is bitwise the same at any M and
wherever it sits in x. At decode sizes in bf16 (and up to 256 rows
where that is faster) it spreads the parts of K across blocks through an
f32 workspace and keeps counters in a buffer shared by the launches of
its (device, stream), so those launches must run in stream order, as
launches on one stream do.

impl: ``"auto"`` — the kernel for CUDA tensors, the plain version for
CPU tensors; ``"kernel"`` — the kernel, raising on anything it cannot
take; ``"reference"`` — the plain version on any device.
``int8_matmul.launches`` counts kernel launches.

The product is the PyTorch operator ``paddle_tpu::int8_matmul`` over
``x2 [M, K]`` (``_op.py``), called while a graph is traced; the reshape
of x stays outside it, and the split workspace and counters are made in
its body.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._op import check_impl, traced, use_kernel

__all__ = ["int8_matmul", "int8_matmul_reference"]

_KERNEL = "int8_matmul"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x, q, scale):
    """f32 (f64 for f64 x) matmul of x with the widened q, times scale,
    one cast to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    out = (x.to(acc) @ q.to(acc)) * scale.to(acc)
    return out.to(x.dtype)


def _lib():
    lib = _build.load(_KERNEL)
    if lib.paddle_int8_matmul.argtypes is None:
        lib.paddle_int8_matmul.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.paddle_int8_matmul.restype = ctypes.c_int
        lib.paddle_int8_matmul_splits.argtypes = [ctypes.c_int] * 3
        lib.paddle_int8_matmul_splits.restype = ctypes.c_int
    return lib


def _launch(x2, q, scale):
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError(f"the int8 matmul kernel takes CUDA tensors, got "
                         f"x on {dev}")
    for name, t in dict(q=q, scale=scale).items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x2.dtype} not supported (float32 or "
                        f"bfloat16)")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scale float32, got {q.dtype}/"
                        f"{scale.dtype}")
    M, K = x2.shape
    N = q.shape[1]
    if K % 8 or N % 16 or M < 1:
        raise ValueError(f"kernel takes K a multiple of 8 and N a multiple "
                         f"of 16 (16-byte copies); got M={M} K={K} N={N}")
    x2, q, scale = x2.contiguous(), q.contiguous(), scale.contiguous()
    if x2.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("int8 matmul: x and q must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x2.dtype, device=dev)
    lib = _lib()
    part = counters = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if x2.dtype == torch.bfloat16:
            # parts of K spread across blocks: an f32 workspace for them
            S = lib.paddle_int8_matmul_splits(M, K, N)
            if S > 1:
                part = torch.empty((S, M, N), dtype=torch.float32,
                                   device=dev)
                counters = _build.tile_counters(
                    dev, stream, -(-M // 64) * -(-N // 64))
        err = lib.paddle_int8_matmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), M, K, N,
            _DTYPE_CODE[x2.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul kernel launch failed (error {err}) "
                           f"for M={M} K={K} N={N} {x2.dtype}")
    int8_matmul.launches += 1
    return out


def _run(x2, q, scale, impl: str):
    if use_kernel(impl, x2):
        return _launch(x2, q, scale)
    return int8_matmul_reference(x2, q, scale)


@torch.library.custom_op("paddle_tpu::int8_matmul", mutates_args=())
def _op(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
        impl: str) -> torch.Tensor:
    return _run(x2, q, scale, impl)


@_op.register_fake
def _(x2, q, scale, impl):
    return x2.new_empty((x2.shape[0], q.shape[1]))


def int8_matmul(x, q, scale, impl: str = "auto"):
    """``x [..., K] @ dequant(q [K, N], scale [N]) -> [..., N]`` in x's
    dtype (module docstring)."""
    check_impl(impl)
    K, N = q.shape
    if x.shape[-1] != K or scale.shape != (N,):
        raise ValueError(f"x [..., {K}] and scale [{N}] expected for q "
                         f"[{K}, {N}]; got x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    out = (_op if traced() else _run)(x2, q, scale, impl)
    return out.reshape(*lead, N)


int8_matmul.launches = 0
