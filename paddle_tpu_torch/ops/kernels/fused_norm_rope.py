"""Fused RMSNorm and rotary embedding for the train step: the hand-written
Hopper kernels' wrappers and their plain PyTorch versions.

Port of ``paddle_tpu/ops/pallas/fused_norm_rope.py`` (one device; the
sharded entries wait for the parallel-training slice).

* ``fused_rms_norm(x, weight, eps, impl)``: y = x·rsqrt(mean(x²)+eps)·w
  in f32, rstd ``[N, 1]`` f32 saved for the backward. The backward gives
  dx = (g·w − x̂·mean(g·w·x̂))·rstd and dw = Σ_rows g·x̂ in f32, cast to
  the weight's dtype. The TPU kernel adds dw into one output block across
  its sequential grid; the CUDA kernel (``csrc/fused_rms_norm.cu``)
  stages each row in shared memory for a group of warps (several rows in
  flight a block), writes f32 partials per fixed chunk of
  ``RMS_DW_CHUNK`` rows (``rms_bwd_workspace``), and a second launch
  sums them in a fixed order, so dw is the same bits from run to run.
* ``fused_rope(q, k, positions, theta, impl)``: rotate-half RoPE on q
  ``[B,T,H,Dh]`` and k ``[B,T,Hkv,Dh]`` in one pass
  (``csrc/fused_rope.cu``), angles in f32 with the TPU kernel's
  ``inv_freq = exp(−log θ · (j mod half)/half)`` (not the
  ``1/θ^(j/half)`` of ``models/llama.rope``, which keeps the unfused
  path). The backward is the same kernel with −positions.

impl: ``"auto"`` — the kernel for CUDA tensors, the plain version for
CPU tensors; ``"kernel"`` — the kernel, raising on anything it cannot
take; ``"reference"`` — the plain version on any device. Each wrapper
counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_rms_norm", "fused_rope", "rms_norm_fwd", "rms_norm_bwd",
           "rope_rotate", "rms_bwd_workspace", "RMS_DW_CHUNK",
           "RMS_BWD_MAX_D"]

RMS_DW_CHUNK = 16      # rows per dw partial (csrc/fused_rms_norm.cu kChunk)
RMS_BWD_MAX_D = 8192   # widest row the backward kernel takes (kMaxD)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError(f"impl must be auto|kernel|reference, got {impl!r}")


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    return impl == "kernel" or (impl == "auto" and t.is_cuda)


def _check_cuda(name: str, dtype, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                             f"one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or "
                        f"bfloat16)")


def _err(name: str, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err}) "
                           f"for {what}")


def _fn(lib_name: str, sym: str, n_ptr: int, tail):
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _acc(x):
    """``x`` in its accumulation type: f32, or f64 for f64 inputs (the
    exact evaluation the card's checks compare against)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# RMSNorm: plain versions
# ---------------------------------------------------------------------------

def _rms_fwd_plain(x2, w, eps: float):
    x = _acc(x2)
    rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * rstd * _acc(w)).to(x2.dtype), rstd


def _rms_bwd_plain(x2, w, rstd, g2):
    x = _acc(x2)
    g = _acc(g2)
    xhat = x * rstd
    gw = g * _acc(w)
    dx = (gw - xhat * (gw * xhat).mean(-1, keepdim=True)) * rstd
    return dx.to(x2.dtype), (g * xhat).sum(0)


# ---------------------------------------------------------------------------
# RMSNorm: kernel wrappers
# ---------------------------------------------------------------------------

def _rms_fwd_kernel(x2, w, eps: float):
    _check_cuda("fused_rms_norm", x2.dtype, x2, w)
    if w.dtype != x2.dtype or w.shape != (x2.shape[1],):
        raise TypeError(f"fused_rms_norm: weight must be [{x2.shape[1]}] "
                        f"{x2.dtype}, got {tuple(w.shape)} {w.dtype}")
    N, D = x2.shape
    if D % 8:
        raise ValueError(f"fused_rms_norm: D={D} must be a multiple of 8")
    y = torch.empty_like(x2)
    rstd = torch.empty((N, 1), dtype=torch.float32, device=x2.device)
    if N:
        fn = _fn("fused_rms_norm", "paddle_rms_norm_fwd", 4,
                 [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int])
        with torch.cuda.device(x2.device):
            err = fn(x2.data_ptr(), w.data_ptr(), y.data_ptr(),
                     rstd.data_ptr(), N, D, float(eps),
                     _DTYPE_CODE[x2.dtype],
                     torch.cuda.current_stream().cuda_stream)
        _err("fused_rms_norm forward", err, f"N={N} D={D} {x2.dtype}")
    rms_norm_fwd.launches += 1
    return y, rstd


def rms_bwd_workspace(N: int, D: int) -> tuple:
    """Shape of the backward kernel's f32 scratch for ``x [N, D]``: one
    row of dw column sums per fixed chunk of ``RMS_DW_CHUNK`` rows, and
    one row when N is 0."""
    return (max(-(-N // RMS_DW_CHUNK), 1), D)


def _rms_bwd_kernel(x2, w, rstd, g2):
    _check_cuda("fused_rms_norm backward", x2.dtype, x2, w, rstd, g2)
    if g2.dtype != x2.dtype or g2.shape != x2.shape:
        raise TypeError("fused_rms_norm backward: g must match x")
    if w.dtype != x2.dtype or w.shape != (x2.shape[1],):
        raise TypeError(f"fused_rms_norm backward: weight must be "
                        f"[{x2.shape[1]}] {x2.dtype}, got {tuple(w.shape)} "
                        f"{w.dtype}")
    if rstd.dtype != torch.float32 or rstd.shape != (x2.shape[0], 1):
        raise TypeError("fused_rms_norm backward: rstd must be float32 "
                        "[N, 1]")
    N, D = x2.shape
    if D % 8 or not 0 < D <= RMS_BWD_MAX_D:
        raise ValueError(f"fused_rms_norm backward: D={D} must be a "
                         f"multiple of 8 in [8, {RMS_BWD_MAX_D}]")
    if any(t.data_ptr() % 16 for t in (x2, w, g2)):
        raise ValueError("fused_rms_norm backward: x, weight and g must be "
                         "16-byte aligned")
    dx = torch.empty_like(x2)
    partial = torch.empty(rms_bwd_workspace(N, D), dtype=torch.float32,
                          device=x2.device)
    dw = torch.empty((D,), dtype=torch.float32, device=x2.device)
    fn = _fn("fused_rms_norm", "paddle_rms_norm_bwd", 7,
             [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(),
                 g2.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), N, D, _DTYPE_CODE[x2.dtype],
                 torch.cuda.current_stream().cuda_stream)
    _err("fused_rms_norm backward", err, f"N={N} D={D} {x2.dtype}")
    rms_norm_bwd.launches += 1
    return dx, dw


def rms_norm_fwd(x2, w, eps: float, impl: str = "auto"):
    """``x2 [N, D]`` -> ``(y [N, D] in x's dtype, rstd [N, 1] f32)``;
    ``.launches`` counts kernel launches."""
    _check_impl(impl)
    if _use_kernel(impl, x2):
        return _rms_fwd_kernel(x2, w, eps)
    return _rms_fwd_plain(x2, w, eps)


def rms_norm_bwd(x2, w, rstd, g2, impl: str = "auto"):
    """-> ``(dx [N, D] in x's dtype, dw [D] f32)``; ``.launches`` counts
    kernel calls (one per call: dx with the dw partials, and their sum)."""
    _check_impl(impl)
    if _use_kernel(impl, x2):
        return _rms_bwd_kernel(x2, w, rstd, g2)
    return _rms_bwd_plain(x2, w, rstd, g2)


rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps, impl):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        y, rstd = rms_norm_fwd(x2, weight, eps, impl)
        ctx.save_for_backward(x2, weight, rstd)
        ctx.impl = impl
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        x2, weight, rstd = ctx.saved_tensors
        g2 = g.reshape(x2.shape).contiguous()
        dx, dw = rms_norm_bwd(x2, weight, rstd, g2, ctx.impl)
        return dx.reshape(g.shape), dw.to(weight.dtype), None, None


def fused_rms_norm(x, weight, eps: float = 1e-5, impl: str = "auto"):
    """RMSNorm over the last dim of ``x [..., D]``, forward and backward
    through the kernels (see the module docstring for ``impl``)."""
    _check_impl(impl)
    return _RMSNorm.apply(x, weight, float(eps), impl)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_plain(q, k, positions, theta: float):
    """``_rope_kernel``'s arithmetic in torch: roll-based, f32 angles."""
    Dh = q.shape[-1]
    half = Dh // 2
    j = torch.arange(Dh, device=q.device)
    exponent = (j % half).float() / half
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=q.device))
    inv_freq = torch.exp(-log_theta * exponent)                 # [Dh]
    ang = positions.float()[..., None] * inv_freq               # [B, T, Dh]
    # cos/sin of the f32 angle, in f64 for an f64 evaluation
    ang = ang.to(torch.promote_types(q.dtype, torch.float32))
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    sign = torch.where(j < half, -1.0, 1.0).to(q.device)

    def rot(x):
        xf = _acc(x)
        rolled = torch.roll(xf, half, dims=-1)
        return (xf * cos + rolled * sign * sin).to(x.dtype)

    return rot(q), rot(k)


def _rope_kernel(q, k, positions, theta: float):
    _check_cuda("fused_rope", q.dtype, q, k, positions)
    B, T, H, Dh = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, T) or k.shape[3] != Dh \
            or k.dtype != q.dtype:
        raise ValueError(f"fused_rope: k must be [{B}, {T}, Hkv, {Dh}] "
                         f"{q.dtype}, got {tuple(k.shape)} {k.dtype}")
    if positions.shape != (B, T) or positions.dtype != torch.int32:
        raise TypeError(f"fused_rope: positions must be int32 [{B}, {T}]")
    if Dh % 16 or Dh > 256:
        raise ValueError(f"fused_rope: head_dim {Dh} must be a multiple of "
                         f"16, at most 256")
    oq = torch.empty_like(q)
    ok = torch.empty_like(k)
    if B * T:
        fn = _fn("fused_rope", "paddle_rope", 5,
                 [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int])
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), positions.data_ptr(),
                     oq.data_ptr(), ok.data_ptr(), B, T, H, k.shape[2], Dh,
                     float(theta), _DTYPE_CODE[q.dtype],
                     torch.cuda.current_stream().cuda_stream)
        _err("fused_rope", err, f"q={tuple(q.shape)} k={tuple(k.shape)} "
             f"{q.dtype}")
    rope_rotate.launches += 1
    return oq, ok


def rope_rotate(q, k, positions, theta: float, impl: str = "auto"):
    """One rotation of q and k by ``positions`` (int ``[B, T]``); the
    backward calls it with −positions. ``.launches`` counts kernel
    launches."""
    _check_impl(impl)
    if _use_kernel(impl, q):
        return _rope_kernel(q.contiguous(), k.contiguous(),
                            positions.to(torch.int32).contiguous(), theta)
    return _rope_plain(q, k, positions, theta)


rope_rotate.launches = 0


class _RoPE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, positions, theta, impl):
        ctx.save_for_backward(positions)
        ctx.theta, ctx.impl = theta, impl
        return rope_rotate(q, k, positions, theta, impl)

    @staticmethod
    def backward(ctx, gq, gk):
        (positions,) = ctx.saved_tensors
        # the rotation's transpose is the rotation by the negated angle
        dq, dk = rope_rotate(gq, gk, -positions, ctx.theta, ctx.impl)
        return dq, dk, None, None, None


def fused_rope(q, k, positions, theta: float = 10000.0, impl: str = "auto"):
    """Rotary embedding on q ``[B,T,H,Dh]`` and k ``[B,T,Hkv,Dh]`` in one
    fused pass; positions int ``[B, T]``. Returns ``(q_rot, k_rot)``."""
    _check_impl(impl)
    return _RoPE.apply(q, k, positions, float(theta), impl)
