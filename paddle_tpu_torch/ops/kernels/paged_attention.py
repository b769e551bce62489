"""Decode attention over a paged KV cache: the hand-written Hopper
kernel's wrappers and its plain PyTorch version.

Port of the two TPU kernels of ``paddle_tpu/inference/paged_kv.py``: the
stock Pallas ``paged_attention`` kernel (``paged_attention`` :182) and
``_stats_call`` :234, the same kernel body returning the softmax stats.
One query token per sequence against its valid pages. Layout contract
(the JAX package's):

* q ``[B, H, Dh]``;
* ``k_pages``/``v_pages`` ``[Hkv, P, page_size, Dh]`` — one layer's pool;
* ``lengths [B]`` int32 — valid keys of each sequence (positions
  ``0 .. lengths[b] - 1``); ``page_indices [B, pages_per_seq]`` int32.
  Table entries past the length, and page slots past the length inside
  the last page, may hold anything (the trash page, stale or NaN rows):
  they are never read into an output.

``paged_attention`` returns o ``[B, H, Dh]``; ``paged_attention_stats``
returns ``(o, m, l)``: m the max of the f32 scores ``[B, H]``, l the
softmax denominator ``sum exp(s - m)``. o is in the pools' dtype, m and l
in f32. Both fold ``sm_scale`` into q first, in q's dtype, as the TPU
entry does; pass ``sm_scale=1.0`` for a q already scaled.

impl: ``"auto"`` — the kernel (``csrc/paged_attention.cu``) for CUDA
tensors, the plain version for CPU tensors; ``"kernel"`` — the kernel,
raising on anything it cannot take; ``"reference"`` — the plain version
on any device (tests and the kernel's comparison only). Launch counts:
``paged_attention.launches`` and ``paged_attention_stats.launches``.

The kernel splits each row's keys into chunks of ``KEY_CHUNK`` at fixed
positions and adds their partials in order (``split_plan`` sizes its
f32 workspace); the last block of a row finds itself through counters
kept per (device, stream), so launches that share a stream must run in
stream order, as launches on one stream do.

Both entries are PyTorch operators, ``paddle_tpu::paged_attention`` and
``paddle_tpu::paged_attention_stats`` (``_op.py``), called while a graph
is traced; the workspace and counters are made in their bodies, and for
B == 0 their fakes give empty outputs of the right shapes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build
from ._op import acc_dtype, check_impl, traced, use_kernel

__all__ = ["paged_attention", "paged_attention_stats",
           "paged_attention_reference", "HEAD_DIMS", "GROUPS", "KEY_CHUNK",
           "split_plan"]

_KERNEL = "paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)         # the kernel's instantiations (csrc)
GROUPS = (1, 2, 4, 8)         # query heads per kv head
_MASK = -1e30
# keys a kernel block walks: the fixed split of the key axis
# (``kChunk`` of csrc/decode_attention.cuh; checked when the library loads)
KEY_CHUNK = 512


def split_plan(max_keys: int, rows: int, head_dim: int) -> tuple:
    """``(chunks, workspace floats)`` of one decode-attention launch (this
    kernel's and the ragged kernel's): ``max_keys`` is the page table's
    width in keys (pages a row x page size), ``rows`` the output rows
    (tokens x H). The chunk count follows the table alone, never the
    lengths, the batch or the card. One chunk needs no workspace; more
    keep each row's per-chunk (O, m, l): ``head_dim + 2`` floats a row
    and chunk."""
    chunks = max(1, -(-int(max_keys) // KEY_CHUNK))
    return chunks, (0 if chunks == 1 else chunks * rows * (head_dim + 2))


def workspace(q, max_keys: int, rows: int, stream: int, n_counters: int):
    """The f32 workspace and the last-block counters (one a query tile and
    kv head) of one launch; ``None, None`` when the keys fit one chunk."""
    chunks, floats = split_plan(max_keys, rows, q.shape[-1])
    if chunks == 1:
        return None, None
    return (torch.empty((floats,), dtype=torch.float32, device=q.device),
            _build.tile_counters(q.device, stream, n_counters))


def check_key_chunk(lib) -> None:
    fn = lib.paddle_decode_attention_key_chunk
    fn.argtypes, fn.restype = [], ctypes.c_int
    if fn() != KEY_CHUNK:
        raise RuntimeError(f"kernel key chunk {fn()} != KEY_CHUNK "
                           f"{KEY_CHUNK}")


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              sm_scale=None):
    """``_ref_paged_attention_stats`` of the JAX package with the scale
    folded into q first: each sequence's pages gathered, positions
    ``>= lengths[b]`` masked. The score product runs in the operand
    dtype, the softmax in f32 (f64 for f64 inputs), the PV product on
    the probabilities cast to v's dtype, then divided by l in v's dtype.
    Masked V rows are zeroed, so NaN there never reaches o; a sequence
    of length 0 gives o = 0, m = -1e30, l = 0. Returns ``(o, m, l)``."""
    B, H, Dh = q.shape
    Hkv, _, ps, _ = k_pages.shape
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    qs = (q * sm_scale).to(q.dtype).reshape(B, Hkv, G, Dh)
    tab = page_indices.long()
    S = tab.shape[1] * ps
    k = k_pages[:, tab].reshape(Hkv, B, S, Dh)
    v = v_pages[:, tab].reshape(Hkv, B, S, Dh)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                 # [B, S]
    v = torch.where(mask[None, :, :, None], v, 0)
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bkgd,kbsd->bkgs", qs, k).to(acc)
    s = torch.where(mask[:, None, None, :], s, _MASK)
    m = s.amax(-1)
    p = torch.where(mask[:, None, None, :], torch.exp(s - m[..., None]), 0)
    l = p.sum(-1)
    o = torch.einsum("bkgs,kbsd->bkgd", p.to(v.dtype), v)
    o = o / torch.where(l > 0, l, 1.0)[..., None].to(v.dtype)
    return (o.reshape(B, H, Dh).to(v_pages.dtype), m.reshape(B, H),
            l.reshape(B, H))


def _lib():
    lib = _build.load(_KERNEL)
    fn = lib.paddle_paged_attention
    if fn.argtypes is None:
        check_key_chunk(lib)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, lengths, page_indices):
    if q.device.type != "cuda":
        raise ValueError(f"the paged-attention kernel takes CUDA tensors, "
                         f"got q on {q.device}")
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages, lengths=lengths,
                 page_indices=page_indices)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
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
    for name in ("lengths", "page_indices"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got "
                            f"{named[name].dtype}")
    B, H, Dh = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != Dh:
        raise ValueError(f"pools must be [Hkv, P, page_size, {Dh}], got "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if lengths.shape != (B,) or page_indices.dim() != 2 \
            or page_indices.shape[0] != B:
        raise ValueError(f"lengths must be [{B}] and page_indices "
                         f"[{B}, pages_per_seq]")
    Hkv = k_pages.shape[0]
    if H % Hkv or H // Hkv not in GROUPS or Dh not in HEAD_DIMS:
        raise ValueError(f"kernel supports head_dim in {HEAD_DIMS} and "
                         f"H/Hkv in {GROUPS}; got Dh={Dh}, H={H}, "
                         f"Hkv={Hkv}")


def _launch(q, k_pages, v_pages, lengths, page_indices, sm_scale,
            stats: bool):
    _check(q, k_pages, v_pages, lengths, page_indices)
    B, H, Dh = q.shape
    Hkv, P, ps, _ = k_pages.shape
    pps = page_indices.shape[1]
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if B == 0:
        return o, m, l
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, counters = workspace(q, pps * ps, B * H, stream, B * Hkv)
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 lengths.data_ptr(), page_indices.data_ptr(), o.data_ptr(),
                 m.data_ptr() if stats else None,
                 l.data_ptr() if stats else None,
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(), B, H,
                 Hkv, Dh, P, ps, pps, float(sm_scale), _DTYPE_CODE[q.dtype],
                 int(stats), stream)
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed (error "
                           f"{err}) for B={B} H={H} Hkv={Hkv} Dh={Dh} "
                           f"page_size={ps} dtype={q.dtype}")
    return o, m, l


def _run(q, k_pages, v_pages, lengths, page_indices, sm_scale: float,
         impl: str, stats: bool):
    if use_kernel(impl, q):
        out = _launch(q, k_pages, v_pages, lengths, page_indices, sm_scale,
                      stats)
        fn = paged_attention_stats if stats else paged_attention
        fn.launches += 1
        return out if stats else out[0]
    o, m, l = paged_attention_reference(q, k_pages, v_pages, lengths,
                                        page_indices, sm_scale)
    o = o.contiguous()
    return (o, m.contiguous(), l.contiguous()) if stats else o


@torch.library.custom_op("paddle_tpu::paged_attention", mutates_args=())
def _op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        lengths: torch.Tensor, page_indices: torch.Tensor, sm_scale: float,
        impl: str) -> torch.Tensor:
    return _run(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl,
                stats=False)


@_op.register_fake
def _(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl):
    return q.new_empty(q.shape, dtype=v_pages.dtype)


@torch.library.custom_op("paddle_tpu::paged_attention_stats",
                         mutates_args=())
def _stats_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              lengths: torch.Tensor, page_indices: torch.Tensor,
              sm_scale: float, impl: str
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _run(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl,
                stats=True)


@_stats_op.register_fake
def _(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl):
    # B == 0 gives empty outputs of these shapes
    B, H, _ = q.shape
    ml = acc_dtype(q.dtype)
    return (q.new_empty(q.shape, dtype=v_pages.dtype),
            q.new_empty((B, H), dtype=ml), q.new_empty((B, H), dtype=ml))


def _call(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl,
          stats: bool):
    check_impl(impl)
    if q.shape[1] % k_pages.shape[0]:
        raise ValueError(f"H={q.shape[1]} not a multiple of "
                         f"Hkv={k_pages.shape[0]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_pages, v_pages, lengths, page_indices, float(sm_scale),
            impl)
    if traced():
        return (_stats_op if stats else _op)(*args)
    return _run(*args, stats=stats)


def paged_attention(q, k_pages, v_pages, lengths, page_indices,
                    sm_scale=None, impl: str = "auto"):
    """o ``[B, H, Dh]`` in the pools' dtype (module docstring)."""
    return _call(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl,
                 stats=False)


def paged_attention_stats(q, k_pages, v_pages, lengths, page_indices,
                          sm_scale=None, impl: str = "auto"):
    """``(o [B, H, Dh], m [B, H] f32, l [B, H] f32)`` (module
    docstring)."""
    return _call(q, k_pages, v_pages, lengths, page_indices, sm_scale, impl,
                 stats=True)


paged_attention.launches = 0
paged_attention_stats.launches = 0
