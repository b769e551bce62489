"""Host-side page allocator of the paged (block-table) KV cache.

Copy of ``PagePool`` from ``paddle_tpu/inference/paged_kv.py`` (numpy
only): the serving engine allocates pages as sequences are admitted and
frees them when streams finish; the tick only ever sees the pool
tensors and the int32 page tables.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["PagePool"]


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
