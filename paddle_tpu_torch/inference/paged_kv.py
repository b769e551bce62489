"""Paged (block-table) KV cache: the host-side page allocator, the page
writes and the decode attention over pages.

Port of ``paddle_tpu/inference/paged_kv.py``:

* ``PagePool`` (numpy only): the serving engine allocates pages as
  sequences are admitted and frees them when streams finish; the device
  code only ever sees the pool tensors and the int32 page tables;
* ``paged_attention`` — one query token per sequence over its valid
  pages (the Hopper kernel of ``ops/kernels/paged_attention``);
* ``paged_attention_with_tail`` — the split decode of ``generate_paged``:
  attention over the paged prompt (the stats kernel) merged with a dense
  tail of generated tokens by the exact flash combine;
* ``prompt_pages_from_dense`` (pages by pure reshape),
  ``write_token_pages``, ``write_prompt_pages`` and ``apply_defrag``.

The page writes update the pools IN PLACE and return them (the JAX
functions return new arrays); ``apply_defrag`` returns new tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

# decode attention over pages, q [B, H, Dh] one token per sequence:
# ``lengths`` counts the valid keys INCLUDING the one just written
from ..ops.kernels.paged_attention import (paged_attention,
                                           paged_attention_stats)

__all__ = ["PagePool", "paged_attention", "paged_attention_with_tail",
           "prompt_pages_from_dense", "write_token_pages",
           "write_prompt_pages", "apply_defrag"]


class PagePool:
    """Free-list allocator over ``total_pages`` KV pages. Page 0 is
    reserved as the trash page that masked writes land on, so valid
    tables never contain 0."""

    TRASH = 0

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.page_size = int(page_size)
        self.total_pages = int(total_pages)
        self._free: List[int] = list(range(total_pages - 1, 0, -1))
        # membership mirror of the free list: free() validates against it
        # so a double-free or out-of-range id raises instead of silently
        # aliasing two sequences onto one page later
        self._free_set = set(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: need {n}, have {len(self._free)} "
                f"of {self.total_pages}")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, pages) -> None:
        """Return pages to the free list. Rejects out-of-range ids,
        pages that are already free, and duplicates within one call —
        all-or-nothing: a rejected call frees NOTHING."""
        ids = [int(p) for p in pages]
        ids = [p for p in ids if p != self.TRASH]
        for p in ids:
            if not 0 < p < self.total_pages:
                raise ValueError(
                    f"free(): page id {p} out of range (valid ids are "
                    f"1..{self.total_pages - 1}; 0 is the trash page)")
            if p in self._free_set:
                raise ValueError(
                    f"free(): double free of page {p} (already on the "
                    f"free list)")
        if len(set(ids)) != len(ids):
            dup = sorted(p for p in set(ids) if ids.count(p) > 1)
            raise ValueError(f"free(): duplicate page ids in one call: "
                             f"{dup}")
        self._free.extend(ids)
        self._free_set.update(ids)

    @property
    def free_page_ids(self) -> frozenset:
        """Snapshot of the free ids."""
        return frozenset(self._free_set)

    @property
    def used_pages(self) -> int:
        """Pages currently handed out (trash page excluded)."""
        return self.total_pages - 1 - len(self._free)

    @property
    def utilization(self) -> float:
        """Fraction of allocatable pages currently in use."""
        return self.used_pages / max(self.total_pages - 1, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def pages_for_len(self, length: int) -> int:
        """How many pages ``length`` tokens need (>= 1)."""
        return max(1, -(-int(length) // self.page_size))

    def defrag_plan(self) -> Dict[int, int]:
        """Compaction plan ``{old_page: new_page}`` moving every USED
        page down to the lowest free indices (1..used). Empty when
        already compact. The free list is NOT mutated here: call
        ``commit_defrag`` after the pool tensors and tables have been
        rewritten, so a failed rewrite cannot desync the allocator."""
        used = sorted(set(range(1, self.total_pages)) - set(self._free))
        return {old: new for new, old in enumerate(used, start=1)
                if old != new}

    def commit_defrag(self, plan: Dict[int, int]) -> None:
        """Point the free list at the pages vacated by ``plan``; raises
        if the pool changed incompatibly since ``defrag_plan()`` (an
        interleaved alloc/free would otherwise alias two sequences onto
        one page)."""
        if not plan:
            return
        used_now = set(range(1, self.total_pages)) - set(self._free)
        if not set(plan).issubset(used_now):
            raise RuntimeError(
                "commit_defrag: plan references pages freed since "
                "defrag_plan() — recompute the plan")
        if set(plan.values()) & (used_now - set(plan)):
            raise RuntimeError(
                "commit_defrag: plan destinations were allocated since "
                "defrag_plan() — recompute the plan")
        used_after = (used_now - set(plan)) | set(plan.values())
        self._free = sorted(set(range(1, self.total_pages)) - used_after,
                            reverse=True)
        self._free_set = set(self._free)


# ---------------------------------------------------------------------------
# decode attention over pages
# ---------------------------------------------------------------------------

def paged_attention_with_tail(q, k_pages, v_pages, prompt_lens,
                              page_indices, k_tail, v_tail, n_valid,
                              sm_scale: Optional[float] = None,
                              impl: str = "auto"):
    """Decode attention over the paged PROMPT KV merged with a dense TAIL
    of generated tokens.

    q ``[B, H, Dh]``; k_tail/v_tail ``[B, Nt, Hkv, Dh]`` with the first
    ``n_valid`` (an int or a 0-d tensor) slots live (slot j holds the j-th GENERATED token of each
    sequence, at position ``prompt_lens[b] + j``). The pages go through
    the stats kernel (o normalized, m, l); the tail, at most
    ``max_new_tokens`` wide, is plain torch; the two merge by
        m = max(m_p, m_t);
        out = (e^{m_p-m} l_p o_p + e^{m_t-m} o_t) / (e^{m_p-m} l_p + e^{m_t-m} l_t)
    with the JAX package's dtypes: normalized o_p in the pools' dtype,
    the weights cast to it, an f32 denominator."""
    B, H, Dh = q.shape
    Hkv = k_pages.shape[0]
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    qs = (q * sm_scale).to(q.dtype)
    o_p, m_p, l_p = paged_attention_stats(qs, k_pages, v_pages, prompt_lens,
                                          page_indices, 1.0, impl)
    # tail part (dense, tiny): the same scaled-q contract
    Nt = k_tail.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = qs.reshape(B, Hkv, G, Dh)
    s_t = torch.einsum("bkgd,bjkd->bkgj", qg, k_tail).to(acc)
    live = torch.arange(Nt, device=q.device) < n_valid
    s_t = torch.where(live, s_t, -1e30)
    m_t = s_t.amax(-1)
    p_t = torch.where(live, torch.exp(s_t - m_t[..., None]), 0.0)
    l_t = p_t.sum(-1).reshape(B, H)
    o_t = torch.einsum("bkgj,bjkd->bkgd", p_t.to(v_tail.dtype),
                       v_tail).reshape(B, H, Dh)            # unnormalized
    m_t = m_t.reshape(B, H)
    m = torch.maximum(m_p, m_t)
    a_p = (torch.exp(m_p - m) * l_p)[..., None]
    a_t = torch.exp(m_t - m)[..., None]
    num = a_p.to(o_p.dtype) * o_p + a_t.to(o_t.dtype) * o_t
    den = a_p[..., 0] * 1.0 + a_t[..., 0] * l_t
    return (num / den[..., None].to(num.dtype)).to(q.dtype)


# ---------------------------------------------------------------------------
# page writes
# ---------------------------------------------------------------------------

def prompt_pages_from_dense(k, v, page_size: int):
    """(k_pages, v_pages, tables) from right-padded prompt KV
    ``[B, T0, Hkv, Dh]`` by pure reshape, no scatter. Page 0 is the
    (zeroed) trash page; sequence b owns pages ``1 + b*pps .. (b+1)*pps``.
    Positions past each length hold the padding KV, which the length
    mask never reads. tables: int32 on k's device."""
    B, T0, Hkv, Dh = k.shape
    ps = page_size
    pps = -(-T0 // ps)
    pad = pps * ps - T0

    def to_pages(x):
        out = x.new_zeros((Hkv, 1 + B * pps, ps, Dh))
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, Hkv, Dh))], dim=1)
        out[:, 1:] = x.reshape(B * pps, ps, Hkv, Dh).permute(2, 0, 1, 3)
        return out

    tables = (1 + torch.arange(B * pps, dtype=torch.int32,
                               device=k.device)).reshape(B, pps)
    return to_pages(k), to_pages(v), tables


def write_token_pages(k_pages, v_pages, k_t, v_t, lengths, page_indices):
    """Write ONE new token per sequence at position ``lengths[b]``, in
    place. k_t/v_t ``[B, Hkv, Dh]``. A sequence whose table row has run
    out of pages writes to the trash page. Returns (k_pages, v_pages)."""
    ps = k_pages.shape[2]
    pps = page_indices.shape[1]
    B = k_t.shape[0]
    b_idx = torch.arange(B, device=k_t.device)
    lengths = lengths.long()
    slot = lengths // ps
    page = torch.where(slot < pps,
                       page_indices[b_idx, slot.clamp(max=pps - 1)].long(),
                       PagePool.TRASH)
    off = lengths % ps
    k_pages[:, page, off] = k_t.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page, off] = v_t.transpose(0, 1).to(v_pages.dtype)
    return k_pages, v_pages


def write_prompt_pages(k_pages, v_pages, k, v, lengths, page_indices,
                       offset: int = 0):
    """Write a whole (right-padded) prompt's KV ``[B, T0, Hkv, Dh]`` in
    place: k[:, t] lands at cache position ``offset + t``; positions
    ``t >= lengths[b]`` land on the trash page (``lengths`` counts the
    valid tokens of THIS write, e.g. of one chunk). Returns (k_pages,
    v_pages)."""
    B, T0 = k.shape[0], k.shape[1]
    ps = k_pages.shape[2]
    pps = page_indices.shape[1]
    t = torch.arange(T0, device=k.device)[None, :]             # [1, T0]
    valid = t < lengths.to(k.device).long()[:, None]           # [B, T0]
    t_abs = t + int(offset)
    slot = torch.clamp(t_abs // ps, max=pps - 1).expand(B, T0)
    page = torch.gather(page_indices.long(), 1, slot)
    page = torch.where(valid, page, PagePool.TRASH)
    off = (t_abs % ps).expand(B, T0)
    k_pages[:, page, off] = k.permute(2, 0, 1, 3).to(k_pages.dtype)
    v_pages[:, page, off] = v.permute(2, 0, 1, 3).to(v_pages.dtype)
    return k_pages, v_pages


def apply_defrag(plan: Dict[int, int], k_pages, v_pages, tables,
                 page_axis: int = -3):
    """Pool tensors and tables rewritten per a ``PagePool.defrag_plan()``
    (the page dim at ``page_axis``: ``[Hkv, P, ps, Dh]`` and
    ``[L, Hkv, P, ps, Dh]`` pools alike). Returns new ``(k_pages,
    v_pages, tables)``; callers then ``commit_defrag(plan)``."""
    if not plan:
        return k_pages, v_pages, tables
    P_total = k_pages.shape[page_axis]
    src = np.arange(P_total, dtype=np.int64)
    dst_map = np.arange(P_total, dtype=np.int64)
    for old, new in plan.items():
        src[new] = old          # gather: new slot <- old page's contents
        dst_map[old] = new      # remap: table entries old -> new
    gather = torch.from_numpy(src).to(k_pages.device)
    k_pages = torch.index_select(k_pages, page_axis % k_pages.dim(), gather)
    v_pages = torch.index_select(v_pages, page_axis % v_pages.dim(), gather)
    tables = torch.as_tensor(tables)
    remap = torch.from_numpy(dst_map).to(tables.device)
    return k_pages, v_pages, remap[tables.long()].to(tables.dtype)
