"""Causal GQA flash attention for the train step: the hand-written Hopper
kernels' wrappers and their plain PyTorch version.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Layout contract
(the JAX package's): q ``[B, T, H, Dh]``, k/v ``[B, S, Hkv, Dh]`` with
``H % Hkv == 0`` (GQA read natively, no repeat), ``S >= T``; the causal
mask is aligned bottom-right (offset ``S - T``), so with a cached prefix
every query sees the whole prefix plus its own causal window.

``flash_attention(q, k, v, causal, sm_scale, impl)``:

* the kernel path (``csrc/flash_attention.cu``): q is pre-scaled by
  ``sm_scale`` and rounded to the input dtype (``prescale_q``, one
  elementwise op outside the kernels, as splash does), detached; the
  forward takes q (the gradient lands on it) and the scaled copy, runs
  the forward kernel on the copy and saves it with lse (f32
  ``[B, H, T]``). The backward runs the dq kernel (which also writes
  delta = rowsum(dO∘O) and scales dq by ``sm_scale``) and then the dkv
  kernel; no atomics, so the gradients are the same bits from run to
  run. bf16 runs on the tensor-core kernels, f32 on the FMA kernels
  (the card checks' precision path); nothing else;
* the plain version of an eager call is ``_dense_reference``, the JAX
  package's dense formulation, with its autograd gradient. It stays so
  because the eager CPU path is held to the JAX package's CPU path,
  which is that formulation: ``tests/test_torch_train.py``'s three
  AdamW steps match JAX's final params at 1e-5 only on it. AdamW
  divides each update by the gradient's running scale, so a last-ulp
  difference in a near-zero gradient becomes a whole update; with the
  kernels' plain counterparts below in its place, one of 32768
  ``w_up`` elements lands 5.8e-5 from JAX's.

The three kernels are the PyTorch operators
``paddle_tpu::flash_attention_fwd``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` (``_op.py``), the forward with
``register_autograd`` (the dq operator, then dkv). A traced call
(``torch.compile``, ``torch.export``) goes through them, ``prescale_q``
an aten op of the graph; an eager call runs the same formula directly
(``_FlashAttention``). An operator's body runs below the autograd key,
so its CPU body cannot take ``_dense_reference``'s autograd gradient:
the bodies' plain versions are the kernels' own counterparts, so a
traced call off the kernels (a CPU tensor, ``impl="reference"``)
computes the flash formulation where the same call eager computes the
dense one; the two agree to rounding (the tests hold both to the JAX
package at 1e-5). The counterparts are
``_fwd_plain`` (o and lse), ``_bwd_dq_plain`` and ``_bwd_dkv_plain``
(the softmax backward: dS = P∘(dP − delta)), in f32 (f64 for f64
inputs) with one rounding an output.

impl: ``"auto"`` — the kernels for CUDA tensors, the plain version for
CPU tensors; ``"kernel"`` — the kernels, raising on anything they cannot
take; ``"reference"`` — the plain version on any device. The launch
counts are ``flash_attention_fwd.launches``,
``flash_attention_bwd_dq.launches`` and
``flash_attention_bwd_dkv.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from ._op import acc_dtype, check_impl, direct_function, traced, use_kernel

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "prescale_q", "HEAD_DIMS"]

_KERNEL = "flash_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)        # the kernels' instantiations (csrc)


def _acc(x):
    """f32, or f64 for f64 inputs (the card checks' exact evaluation)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def prescale_q(q, sm_scale: float):
    """``q * sm_scale`` rounded to q's dtype: splash's
    ``(q * sm_scale).astype(q.dtype)``. For bf16 the product is taken in
    f32 and rounded once, the bits the kernels once computed in-kernel as
    ``__float2bfloat16_rn(x * scale)``."""
    return (q * float(sm_scale)).to(q.dtype)


def _dense_reference(q, k, v, causal: bool, sm_scale: float):
    """The JAX package's ``_dense_reference``: scores in the operand
    dtype, scaled, masked and softmaxed in f32 (f64 for f64 inputs),
    probabilities cast back to the operand dtype before the PV
    product."""
    _, T, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k) * sm_scale
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril(S - T)
        scores = torch.where(mask, _acc(scores), -1e30)
    else:
        scores = _acc(scores)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _fn(sym: str, n_ptr: int):
    fn = getattr(_build.load(_KERNEL), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, *more):
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernels take CUDA tensors, "
                         f"got q on {q.device}")
    for t in (q, k, v) + more:
        if t.device != q.device:
            raise ValueError(f"tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention: inputs must be contiguous "
                             "and 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32 or "
                        f"bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v must have q's dtype {q.dtype}")
    B, T, H, Dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != Dh:
        raise ValueError(f"k/v must be [{B}, S, Hkv, {Dh}], got "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if H % Hkv or Dh not in HEAD_DIMS or S < T or T < 1:
        raise ValueError(f"kernel supports head_dim in {HEAD_DIMS}, H a "
                         f"multiple of Hkv and S >= T >= 1; got Dh={Dh}, "
                         f"H={H}, Hkv={Hkv}, T={T}, S={S}")


def _shape_args(q, k, sm_scale, causal):
    B, T, H, Dh = q.shape
    return (B, T, k.shape[1], H, k.shape[2], Dh, float(sm_scale),
            int(bool(causal)), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)


def _raise(err: int, what: str, q, k) -> None:
    if err != 0:
        raise RuntimeError(f"flash-attention {what} kernel launch failed "
                           f"(error {err}) for q={tuple(q.shape)} "
                           f"k={tuple(k.shape)} {q.dtype}")


def flash_attention_fwd(qs, k, v, causal: bool):
    """Forward kernel on the pre-scaled q (``prescale_q``):
    ``(o [B, T, H, Dh], lse f32 [B, H, T])``."""
    _check(qs, k, v)
    B, T, H, _ = qs.shape
    o = torch.empty_like(qs)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = _fn("paddle_flash_fwd", 5)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_shape_args(qs, k, 1.0, causal))
    _raise(err, "forward", qs, k)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(qs, k, v, o, do, lse, causal: bool,
                           sm_scale: float):
    """dq kernel: ``(dq, delta f32 [B, H, T])``, dq for the unscaled q
    (the kernel multiplies by ``sm_scale``); delta feeds the dkv
    kernel."""
    _check(qs, k, v, o, do, lse)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(qs)
    with torch.cuda.device(qs.device):
        err = _fn("paddle_flash_bwd_dq", 8)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_shape_args(qs, k, sm_scale, causal))
    _raise(err, "dq", qs, k)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal: bool):
    """dkv kernel on the pre-scaled q: ``(dk, dv)`` in k's layout."""
    _check(qs, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(qs.device):
        err = _fn("paddle_flash_bwd_dkv", 8)(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(qs, k, 1.0, causal))
    _raise(err, "dkv", qs, k)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# plain counterparts of the three kernels
# ---------------------------------------------------------------------------

def _scores(qs, k, causal: bool):
    """f32 (f64) scores ``[B, H, T, S]`` of the pre-scaled q, masked
    bottom-right causal, and the repeated k/v head index."""
    B, T, H, _ = qs.shape
    S, Hkv = k.shape[1], k.shape[2]
    kk = _acc(k).repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", _acc(qs), kk)
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool,
                          device=qs.device).tril(S - T)
        s = torch.where(mask, s, -1e30)
    return s


def _group_sum(x, Hkv: int):
    """``[B, S, H, Dh]`` per query head -> ``[B, S, Hkv, Dh]``."""
    B, S, H, Dh = x.shape
    return x.reshape(B, S, Hkv, H // Hkv, Dh).sum(3)


def _fwd_plain(qs, k, v, causal: bool):
    """The forward kernel's function in f32 (f64 for f64 inputs), one
    rounding: ``(o, lse [B, H, T])``."""
    s = _scores(qs, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vv = _acc(v).repeat_interleave(qs.shape[2] // v.shape[2], dim=2)
    o = torch.einsum("bhts,bshd->bthd", p, vv)
    return o.to(qs.dtype).contiguous(), lse


def _probs(qs, k, lse, causal: bool):
    return torch.exp(_scores(qs, k, causal) - lse[..., None])


def _bwd_dq_plain(qs, k, v, o, do, lse, causal: bool, sm_scale: float):
    """The softmax backward's dq and delta: delta = rowsum(dO∘O),
    dS = P∘(dP − delta), dq = sm_scale · dS·K."""
    H, Hkv = qs.shape[2], k.shape[2]
    p = _probs(qs, k, lse, causal)
    dof = _acc(do)
    delta = (dof * _acc(o)).sum(-1).transpose(1, 2)          # [B, H, T]
    dp = torch.einsum("bthd,bshd->bhts", dof,
                      _acc(v).repeat_interleave(H // Hkv, dim=2))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds,
                      _acc(k).repeat_interleave(H // Hkv, dim=2))
    return (dq * sm_scale).to(qs.dtype).contiguous(), delta.contiguous()


def _bwd_dkv_plain(qs, k, v, do, lse, delta, causal: bool):
    """dk = dSᵀ·qs and dv = Pᵀ·dO, summed over each kv head's group."""
    H, Hkv = qs.shape[2], k.shape[2]
    p = _probs(qs, k, lse, causal)
    dof = _acc(do)
    dp = torch.einsum("bthd,bshd->bhts", dof,
                      _acc(v).repeat_interleave(H // Hkv, dim=2))
    ds = p * (dp - delta[..., None])
    dk = _group_sum(torch.einsum("bhts,bthd->bshd", ds, _acc(qs)), Hkv)
    dv = _group_sum(torch.einsum("bhts,bthd->bshd", p, dof), Hkv)
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _fwd_run(q, qs, k, v, causal: bool, sm_scale: float, impl: str):
    if use_kernel(impl, qs):
        return flash_attention_fwd(qs, k, v, causal)
    return _fwd_plain(qs, k, v, causal)


def _dq_run(qs, k, v, o, do, lse, causal: bool, sm_scale: float,
            impl: str):
    if use_kernel(impl, qs):
        return flash_attention_bwd_dq(qs, k, v, o, do, lse, causal,
                                      sm_scale)
    return _bwd_dq_plain(qs, k, v, o, do, lse, causal, sm_scale)


def _dkv_run(qs, k, v, do, lse, delta, causal: bool, impl: str):
    if use_kernel(impl, qs):
        return flash_attention_bwd_dkv(qs, k, v, do, lse, delta, causal)
    return _bwd_dkv_plain(qs, k, v, do, lse, delta, causal)


@torch.library.custom_op("paddle_tpu::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, qs: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool, sm_scale: float, impl: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _fwd_run(q, qs, k, v, causal, sm_scale, impl)


@_fwd_op.register_fake
def _(q, qs, k, v, causal, sm_scale, impl):
    B, T, H, _ = qs.shape
    return (qs.new_empty(qs.shape),
            qs.new_empty((B, H, T), dtype=acc_dtype(qs.dtype)))


@torch.library.custom_op("paddle_tpu::flash_attention_bwd_dq",
                         mutates_args=())
def _dq_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
           causal: bool, sm_scale: float, impl: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _dq_run(qs, k, v, o, do, lse, causal, sm_scale, impl)


@_dq_op.register_fake
def _(qs, k, v, o, do, lse, causal, sm_scale, impl):
    return qs.new_empty(qs.shape), lse.new_empty(lse.shape)


@torch.library.custom_op("paddle_tpu::flash_attention_bwd_dkv",
                         mutates_args=())
def _dkv_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            causal: bool, impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return _dkv_run(qs, k, v, do, lse, delta, causal, impl)


@_dkv_op.register_fake
def _(qs, k, v, do, lse, delta, causal, impl):
    return k.new_empty(k.shape), v.new_empty(v.shape)


def _setup(ctx, inputs, output):
    _, qs, k, v, causal, sm_scale, impl = inputs
    o, lse = output
    ctx.save_for_backward(qs, k, v, o, lse)
    ctx.causal, ctx.sm_scale, ctx.impl = causal, sm_scale, impl


def _backward(dq_fn, dkv_fn, ctx, do, _dlse):
    qs, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    dq, delta = dq_fn(qs, k, v, o, do, lse, ctx.causal, ctx.sm_scale,
                      ctx.impl)
    dk, dv = dkv_fn(qs, k, v, do, lse, delta, ctx.causal, ctx.impl)
    # the gradient lands on q; qs is a detached copy
    return dq, None, dk, dv, None, None, None


_fwd_op.register_autograd(
    lambda ctx, do, dlse: _backward(_dq_op, _dkv_op, ctx, do, dlse),
    setup_context=_setup)
_FlashAttention = direct_function(
    "_FlashAttention", _fwd_run, _setup,
    lambda ctx, do, dlse: _backward(_dq_run, _dkv_run, ctx, do, dlse))


def flash_attention(q, k, v, causal: bool = True, sm_scale=None,
                    impl: str = "auto"):
    """``[B, T, H, Dh]`` attention over ``[B, S, Hkv, Dh]`` keys and
    values; returns ``[B, T, H, Dh]`` in q's dtype (see the module
    docstring for ``impl``)."""
    check_impl(impl)
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} not a multiple of "
                         f"Hkv={k.shape[2]}")
    if k.shape[1] < q.shape[1]:
        raise ValueError(f"S={k.shape[1]} < T={q.shape[1]}: the causal "
                         f"mask is aligned bottom-right and needs S >= T")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[3])
    if traced():
        fn = _fwd_op
    elif use_kernel(impl, q):
        fn = _FlashAttention.apply
    else:       # the JAX package's formulation (module docstring)
        return _dense_reference(q, k, v, causal, sm_scale)
    qs = prescale_q(q.detach().contiguous(), sm_scale)
    o, _ = fn(q, qs, k.contiguous(), v.contiguous(), bool(causal),
              float(sm_scale), impl)
    return o
