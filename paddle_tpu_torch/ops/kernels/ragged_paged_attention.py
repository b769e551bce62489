"""Ragged paged attention for the serving tick: the hand-written Hopper
kernel's wrapper and its plain PyTorch versions.

Port of ``paddle_tpu/ops/pallas/ragged_paged_attention.py``. One call
computes attention for a mixed batch of variable-length sequences —
ragged prefill spans (bottom-right causal within each sequence) and
decode steps (``q_len = 1``) — over per-slot page tables. Sequence
geometry is data, not shape.

Layout contract (the JAX package's, kept at every public function):

* ``k_pages``/``v_pages``: ``[Hkv, P, page_size, Dh]`` — one layer of
  the serving pools; the span's own KV is already written into them;
* ``kv_len[s]`` counts every key visible at the END of slot ``s``'s
  span; query row ``t`` of the span attends keys
  ``0 .. kv_len[s] - q_len[s] + t`` (bottom-right causal);
* ``tables``: ``[S, pages_per_slot]`` int32; entries past the covered
  range may be the trash page (0) and are never read;
* the packed stream: ``q [T, H, Dh]`` with ``tok_slot [T]`` (``S`` =
  padding token) and ``tok_qoff [T]`` (offset inside the slot's span).

``ragged_paged_attention_packed`` is the serving entry. On CUDA tensors
it launches ``csrc/ragged_paged_attention.cu`` (or raises); on CPU
tensors it runs ``_packed_impl``, the plain packed formulation. The
slot-major ``ragged_paged_attention_reference`` (one-shot ``_attend``
or the tiled ``_attend_tiled`` walk) is the plain reference the tests
hold both against.

The plain versions round where the JAX package rounds: the pre-scaled
q, the score product and the PV product run in the operand dtype, the
softmax in f32. The kernel accumulates both products in f32; its
tolerance against the plain version is stated where it is checked. Like
the paged-attention kernel it splits each row's keys into chunks of
``KEY_CHUNK`` at fixed positions (``split_plan``, shared with
``paged_attention``) and keeps per-(device, stream) counters, so launches
that share a stream must run in stream order.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .paged_attention import (KEY_CHUNK, check_key_chunk, split_plan,
                              workspace)

__all__ = ["ragged_paged_attention_packed",
           "ragged_paged_attention_reference", "TILED_ULP_BOUND",
           "tiled_ulp_error", "KEY_CHUNK", "split_plan"]

_MASK = -1e30  # the running max starts here, not at -inf (dead rows -> 0)

# Tiled-vs-one-shot contract, carried over from the JAX package: the
# flash combine (and, for the kernel, any other summation order)
# reassociates the softmax reductions, so the bound is in ulps of the
# dtype AT THE SLOT'S OUTPUT SCALE, not per element:
#     |got - ref| <= TILED_ULP_BOUND * eps(dtype) * linf(slot)
TILED_ULP_BOUND = 16


def tiled_ulp_error(got, ref, eps=None) -> float:
    """Max error of ``got`` vs ``ref`` in units-in-the-last-place of
    each leading-axis row's (slot's) largest reference component — the
    contract metric of ``TILED_ULP_BOUND``. Inputs are same-shape float
    arrays or tensors (any device), slot-major on axis 0. ``eps`` is the
    unit: by default the epsilon of ``ref``'s dtype (2**-7 for a
    bfloat16 tensor); pass one to count in another dtype's ulps."""
    if eps is None:
        eps = (torch.finfo(ref.dtype).eps if isinstance(ref, torch.Tensor)
               else np.finfo(np.asarray(ref).dtype).eps)
    got = _to_f64(got)
    ref = _to_f64(ref)
    axes = tuple(range(1, ref.ndim))
    linf = np.maximum(
        np.max(np.abs(ref), axis=axes, keepdims=True), 1e-30)
    return float((np.abs(got - ref) / (eps * linf)).max())


def _to_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# plain versions (slot-major reference)
# ---------------------------------------------------------------------------

def _attend(qs, ks, vs, q_len: int, kv_len: int, tq: int):
    """One (slot, kv-head) block, one-shot softmax. qs ``[G*Tq, Dh]``
    pre-scaled, rows ordered (g, t); ks/vs ``[KV_max, Dh]`` — positions
    ``>= kv_len`` may hold garbage (the trash page, stale rows) and are
    zeroed so a NaN there never reaches the output. Returns
    ``[G*Tq, Dh]`` in vs.dtype."""
    kv_max = ks.shape[0]
    dev = ks.device
    kmask = torch.arange(kv_max, device=dev)[:, None] < kv_len
    ks = torch.where(kmask, ks, 0)
    vs = torch.where(kmask, vs, 0)
    s = (qs @ ks.T).float()              # score product in operand dtype
    t = torch.arange(s.shape[0], device=dev)[:, None] % tq
    k_idx = torch.arange(kv_max, device=dev)[None, :]
    mask = (t < q_len) & (k_idx <= (kv_len - q_len) + t)
    s = torch.where(mask, s, _MASK)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = p.to(vs.dtype) @ vs
    # fully-masked rows (padding, empty slots): l == 0 -> 0, not NaN
    return (o / torch.where(l > 0, l, 1.0).to(o.dtype)).to(vs.dtype)


def _flash_tile(qs, ks_t, vs_t, k0: int, q_len: int, kv_len: int,
                tq: int, m, l, acc):
    """One tile of the online-softmax (flash-combine) KV walk over keys
    ``k0 .. k0 + tile_kv - 1``; m/l ``[G*Tq, 1]`` and acc
    ``[G*Tq, Dh]`` are the f32 carry. A tile wholly past ``kv_len`` is
    an exact no-op (alpha == 1, p == 0)."""
    gt = qs.shape[0]
    tile_kv = ks_t.shape[0]
    dev = ks_t.device
    k_idx = k0 + torch.arange(tile_kv, device=dev)[None, :]
    vmask = (k0 + torch.arange(tile_kv, device=dev)[:, None]) < kv_len
    vs_t = torch.where(vmask, vs_t, 0)
    s = (qs @ ks_t.T).float()
    t = torch.arange(gt, device=dev)[:, None] % tq
    mask = (t < q_len) & (k_idx <= (kv_len - q_len) + t)
    s = torch.where(mask, s, _MASK)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + (p.to(vs_t.dtype) @ vs_t).float()
    return m_new, l_new, acc_new


def _flash_init(gt: int, dh: int, device):
    """Carry init: the running max starts at the mask value, so
    ``exp(_MASK - _MASK)`` is a defined 1.0 for rows that never see a
    live key and those rows emit 0, not NaN."""
    return (torch.full((gt, 1), _MASK, dtype=torch.float32, device=device),
            torch.zeros((gt, 1), dtype=torch.float32, device=device),
            torch.zeros((gt, dh), dtype=torch.float32, device=device))


def _flash_final(m, l, acc, dtype):
    del m  # fully-masked rows: l == 0 -> emit 0, not NaN
    return (acc / torch.where(l > 0, l, 1.0)).to(dtype)


def _attend_tiled(qs, ks, vs, q_len: int, kv_len: int, tq: int,
                  tile_kv: int):
    """Tiled counterpart of ``_attend``: the same block, the KV axis
    walked in ``tile_kv``-sized tiles through ``_flash_tile``. Held to
    ``TILED_ULP_BOUND`` against ``_attend``."""
    kv_max, dh = ks.shape
    n_tiles = -(-kv_max // tile_kv)
    pad = n_tiles * tile_kv - kv_max
    if pad:
        ks = torch.cat([ks, ks.new_zeros((pad, dh))])
        vs = torch.cat([vs, vs.new_zeros((pad, dh))])
    carry = _flash_init(qs.shape[0], dh, qs.device)
    for t in range(n_tiles):
        k0 = t * tile_kv
        carry = _flash_tile(qs, ks[k0:k0 + tile_kv], vs[k0:k0 + tile_kv],
                            k0, q_len, kv_len, tq, *carry)
    return _flash_final(*carry, vs.dtype)


def _reference_impl(qs, k_pages, v_pages, q_len, kv_len, tables, tq: int,
                    tile_pages: int = 0):
    """Dense-gather reference: per slot, gather the table's pages and
    run ``_attend`` (or ``_attend_tiled`` when ``tile_pages > 0``) per
    kv head. qs ``[S, Hkv, G*Tq, Dh]`` pre-scaled; returns that shape
    in the pools' dtype."""
    S, Hkv, _, Dh = qs.shape
    pps = tables.shape[1]
    ps = k_pages.shape[2]
    out = torch.empty(qs.shape, dtype=v_pages.dtype, device=qs.device)
    tile_kv = min(int(tile_pages), pps) * ps
    for s in range(S):
        qn, kn = int(q_len[s]), int(kv_len[s])
        tab = tables[s].long()
        ks = k_pages[:, tab].reshape(Hkv, pps * ps, Dh)
        vs = v_pages[:, tab].reshape(Hkv, pps * ps, Dh)
        for h in range(Hkv):
            if tile_kv:
                out[s, h] = _attend_tiled(qs[s, h], ks[h], vs[h], qn, kn,
                                          tq, tile_kv)
            else:
                out[s, h] = _attend(qs[s, h], ks[h], vs[h], qn, kn, tq)
    return out


def ragged_paged_attention_reference(q, k_pages, v_pages, q_len, kv_len,
                                     tables, sm_scale=None,
                                     kv_tile_pages: int = 0):
    """Slot-major plain reference. q ``[S, Tq, H, Dh]`` (slot ``s`` owns
    rows ``0 .. q_len[s]-1``); pools ``[Hkv, P, page_size, Dh]``;
    q_len/kv_len ``[S]``; tables ``[S, pages_per_slot]``. Returns
    ``[S, Tq, H, Dh]`` in q.dtype. ``kv_tile_pages > 0`` walks the KV
    axis in tiles of that many pages (the flash combine) instead of
    the one-shot softmax."""
    S, Tq, H, Dh = q.shape
    Hkv = k_pages.shape[0]
    if H % Hkv:
        raise ValueError(f"H={H} not a multiple of Hkv={Hkv}")
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    # [S, Tq, H, Dh] -> [S, Hkv, G*Tq, Dh], rows (g, t)-ordered: the
    # head axis is kv-head-major (H = Hkv*G)
    qs = (q * sm_scale).to(q.dtype)
    qs = qs.reshape(S, Tq, Hkv, G, Dh).permute(0, 2, 3, 1, 4)
    qs = qs.reshape(S, Hkv, G * Tq, Dh)
    out = _reference_impl(qs, k_pages, v_pages, q_len, kv_len, tables,
                          tq=Tq, tile_pages=kv_tile_pages)
    out = out.reshape(S, Hkv, G, Tq, Dh).permute(0, 3, 1, 2, 4)
    return out.reshape(S, Tq, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# plain packed version (the serving tick's CPU path)
# ---------------------------------------------------------------------------

def _packed_impl(q, k_pages, v_pages, tok_slot, tok_qoff, q_len, kv_len,
                 tables, sm_scale):
    """Attention computed directly on the tick's token stream: one
    per-token page gather, the same masks and reduction axes as
    ``_attend``. Padding rows (slot sentinel ``S`` or ``qoff >=
    q_len``) are exact zeros."""
    T, H, Dh = q.shape
    S, pps = tables.shape
    Hkv, _, ps, _ = k_pages.shape
    G = H // Hkv
    KV = pps * ps
    dev = q.device
    qs = (q * sm_scale).to(q.dtype).reshape(T, Hkv, G, Dh)
    sl = tok_slot.clamp(max=S - 1).long()      # padding clamps to slot 0
    tabs_t = tables[sl].long()                  # [T, pps]
    ks = k_pages[:, tabs_t].reshape(Hkv, T, KV, Dh)
    vs = v_pages[:, tabs_t].reshape(Hkv, T, KV, Dh)
    k_idx = torch.arange(KV, device=dev)[None, :]
    kv_t, q_t = kv_len[sl], q_len[sl]
    # K needs no zeroing: every dead score is REPLACED by _MASK below.
    # V keeps it: p is exactly 0 there, but 0 * NaN would still poison
    # the weighted sum
    vs = torch.where((k_idx < kv_t[:, None])[None, :, :, None], vs, 0)
    s = torch.einsum("tkgd,ktsd->tkgs", qs, ks).float()
    hi = (kv_t - q_t + tok_qoff)[:, None]
    mask = ((tok_slot < S)[:, None] & (tok_qoff < q_t)[:, None]
            & (k_idx <= hi))                    # [T, KV]
    m4 = mask[:, None, None, :]
    s = torch.where(m4, s, _MASK)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("tkgs,ktsd->tkgd", p.to(vs.dtype), vs)
    o = o / torch.where(l > 0, l, 1.0).to(o.dtype)
    return o.reshape(T, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

_KERNEL = "ragged_paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)         # the kernel's instantiations (csrc)
GROUPS = (1, 2, 4, 8)         # query heads per kv head


def _lib():
    lib = _build.load(_KERNEL)
    fn = lib.paddle_rpa_packed
    if fn.argtypes is None:
        check_key_chunk(lib)
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, k_pages, v_pages, tok_slot, tok_qoff, q_len,
                       kv_len, tables):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the ragged paged-attention kernel takes CUDA "
                         f"tensors, got q on {dev}")
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages, tok_slot=tok_slot,
                 tok_qoff=tok_qoff, q_len=q_len, kv_len=kv_len,
                 tables=tables)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                             f"copies)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32 or "
                        f"bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"pools must have q's dtype {q.dtype}, got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    for name in ("tok_slot", "tok_qoff", "q_len", "kv_len", "tables"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{named[name].dtype}")
    T, H, Dh = q.shape
    S = tables.shape[0]
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != Dh:
        raise ValueError(f"pools must be [Hkv, P, page_size, {Dh}], got "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if tok_slot.shape != (T,) or tok_qoff.shape != (T,):
        raise ValueError("tok_slot/tok_qoff must be [T]")
    if q_len.shape != (S,) or kv_len.shape != (S,):
        raise ValueError("q_len/kv_len must be [S]")
    Hkv = k_pages.shape[0]
    if H % Hkv or H // Hkv not in GROUPS or Dh not in HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {HEAD_DIMS} and "
                         f"H/Hkv in {GROUPS}; got Dh={Dh}, H={H}, "
                         f"Hkv={Hkv}")


def _launch(q, k_pages, v_pages, tok_slot, tok_qoff, q_len, kv_len, tables,
            sm_scale):
    _check_kernel_args(q, k_pages, v_pages, tok_slot, tok_qoff, q_len,
                       kv_len, tables)
    T, H, Dh = q.shape
    Hkv, P, ps, _ = k_pages.shape
    S, pps = tables.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, counters = workspace(q, pps * ps, T * H, stream, T * Hkv)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tok_slot.data_ptr(), tok_qoff.data_ptr(),
                 q_len.data_ptr(), kv_len.data_ptr(), tables.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(), T, H,
                 Hkv, Dh, P, ps, S, pps, float(sm_scale),
                 _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ragged paged-attention kernel launch failed "
                           f"(error {err}) for T={T} H={H} Hkv={Hkv} "
                           f"Dh={Dh} dtype={q.dtype}")
    ragged_paged_attention_packed.launches += 1
    return out


def ragged_paged_attention_packed(q, k_pages, v_pages, tok_slot, tok_qoff,
                                  q_len, kv_len, tables, sm_scale=None,
                                  impl: str = "auto"):
    """Packed-stream entry of the serving tick: ``q [T, H, Dh]`` with
    per-token owner ``tok_slot [T]`` (``S`` = padding) and span offset
    ``tok_qoff [T]``; pools/q_len/kv_len/tables as in the module
    docstring (int32, on q's device). Returns ``[T, H, Dh]`` in
    q.dtype, padding rows zero.

    impl: ``"auto"`` — the Hopper kernel for CUDA tensors, the plain
    packed version for CPU tensors; ``"kernel"`` — the kernel, raising
    on anything it cannot take; ``"reference"`` — the plain packed
    version on any device (tests and the kernel's comparison only).

    ``ragged_paged_attention_packed.launches`` counts kernel launches.
    """
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError(
            f"impl must be auto|kernel|reference, got {impl!r}")
    H, Dh = q.shape[1], q.shape[2]
    if H % k_pages.shape[0]:
        raise ValueError(f"H={H} not a multiple of Hkv={k_pages.shape[0]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    if impl == "kernel" or (impl == "auto" and q.is_cuda):
        return _launch(q, k_pages, v_pages, tok_slot, tok_qoff, q_len,
                       kv_len, tables, sm_scale)
    return _packed_impl(q, k_pages, v_pages, tok_slot, tok_qoff, q_len,
                        kv_len, tables, sm_scale)


ragged_paged_attention_packed.launches = 0
