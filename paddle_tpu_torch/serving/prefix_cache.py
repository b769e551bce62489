"""Refcounted prefix cache over the paged KV pool.

Copy of ``PrefixCache`` from ``paddle_tpu/serving/prefix_cache.py``:
requests sharing a prompt prefix attach the SAME physical KV pages
instead of recomputing it, so admission prefills only the uncached
suffix.

- **Granularity: full pages.** A cached unit is one FULL KV page (all
  layers — the pool is layer-stacked). Full pages are immutable after
  prefill, so sharing them is write-safe by construction.
- **Keying: a trie keyed by page token tuples.** Dict equality compares
  the actual tuples, so a hash collision can never alias two prefixes.
- **Refcounts + LRU eviction.** ``refs`` counts live requests whose
  table holds the node's page; refcount-0 LEAF nodes are evicted
  LRU-first under page pressure (a parent's children attend to its
  positions, so leaves go first).
- **Match cap: at most ``floor((n-1)/page_size)`` pages.** At least one
  suffix token is always prefilled (its logits pick the first token),
  and the partially filled tail page stays request-private.

Single-threaded by design: the engine calls it on its worker thread
only.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Tuple

__all__ = ["PrefixCache"]


class _Node:
    __slots__ = ("toks", "parent", "children", "page", "refs",
                 "last_used", "hits")

    def __init__(self, toks, parent, page: int, tick: int):
        self.toks = toks                    # this page's token tuple
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.page = int(page)
        self.refs = 0
        self.last_used = tick
        self.hits = 0                       # acquire() attachments

    def __repr__(self):  # debugging aid only
        return (f"_Node(page={self.page}, refs={self.refs}, "
                f"children={len(self.children)})")


class PrefixCache:
    """Page-granular prefix registry over one ``PagePool``. Cached pages
    stay ALLOCATED in the pool until ``evict`` frees them."""

    def __init__(self, pool):
        self.pool = pool
        self.page_size = int(pool.page_size)
        self._root = _Node((), None, -1, 0)
        self._nodes = set()                 # every cached node
        self._tick = itertools.count(1)
        self.evictions = 0

    @property
    def cached_pages(self) -> int:
        return len(self._nodes)

    @property
    def reusable_pages(self) -> int:
        """Cached pages not currently referenced by any live request."""
        return sum(nd.refs == 0 for nd in self._nodes)

    # ------------------------------------------------------------ lookup ----
    def _max_pages(self, n_tokens: int) -> int:
        # never cover the whole prompt: >= 1 token must remain for the
        # suffix prefill (first-token logits + private tail page)
        return max(0, (int(n_tokens) - 1) // self.page_size)

    def _walk(self, prompt, max_pages: int) -> List[_Node]:
        ps = self.page_size
        node, out = self._root, []
        for i in range(max_pages):
            key = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            nxt = node.children.get(key)
            if nxt is None:
                break
            out.append(nxt)
            node = nxt
        return out

    def match_pages(self, prompt) -> int:
        """Non-pinning peek: how many pages ``acquire`` would attach."""
        return len(self._walk(prompt, self._max_pages(len(prompt))))

    def acquire(self, prompt) -> List[_Node]:
        """Longest cached page-aligned prefix of ``prompt``, with every
        attached node's refcount bumped (pinned against eviction). The
        caller owns one release() per acquire()."""
        nodes = self._walk(prompt, self._max_pages(len(prompt)))
        t = next(self._tick)
        for nd in nodes:
            nd.refs += 1
            nd.last_used = t
            nd.hits += 1
        return nodes

    def release(self, nodes: List[_Node]) -> None:
        """Drop one reference per node (request retirement). Pages stay
        cached at zero refs until evicted under pressure."""
        for nd in nodes:
            nd.refs -= 1
            if nd.refs < 0:
                raise RuntimeError(
                    f"prefix-cache refcount underflow on page {nd.page}")

    # ------------------------------------------------------------ insert ----
    def insert(self, prompt, parent_nodes: List[_Node],
               pages: List[int]) -> Tuple[List[_Node], List[int]]:
        """Register a freshly prefilled prompt's full pages.

        ``parent_nodes`` — the chain the request attached at admission
        (possibly empty); ``pages`` — the request's PRIVATE pool pages
        holding prompt tokens ``len(parent_nodes)*ps ..`` in order (full
        pages only).

        Returns ``(adopted, still_private)``: adopted nodes now own their
        page (refs=1 for this request); ``still_private`` pages
        duplicated an existing chain entry and remain the request's to
        free. The request's page table keeps pointing at its own pages
        either way."""
        ps = self.page_size
        node = parent_nodes[-1] if parent_nodes else self._root
        start = len(parent_nodes)
        adopted, still_private = [], []
        t = next(self._tick)
        for i, page in enumerate(pages):
            j = start + i
            key = tuple(int(x) for x in prompt[j * ps:(j + 1) * ps])
            existing = node.children.get(key)
            if existing is not None:
                # identical content already cached: keep ours private;
                # the chain continues through the EXISTING node
                still_private.append(int(page))
                node = existing
                continue
            child = _Node(key, node, page, t)
            child.refs = 1
            node.children[key] = child
            self._nodes.add(child)
            adopted.append(child)
            node = child
        return adopted, still_private

    # ---------------------------------------------------------- eviction ----
    def evict(self, want_pages: int) -> int:
        """Free up to ``want_pages`` refcount-0 LEAF pages back to the
        pool, LRU-first; returns how many were freed. Freeing a leaf can
        expose its parent, which joins the same heap."""
        freed = 0
        if want_pages <= 0:
            return 0
        heap = [(nd.last_used, id(nd), nd) for nd in self._nodes
                if nd.refs == 0 and not nd.children]
        heapq.heapify(heap)
        while heap and freed < want_pages:
            _, _, nd = heapq.heappop(heap)
            if nd.refs or nd.children or nd not in self._nodes:
                continue  # pinned/extended/evicted since it was pushed
            parent = nd.parent
            del parent.children[nd.toks]
            self._nodes.discard(nd)
            self.pool.free([nd.page])
            self.evictions += 1
            freed += 1
            if (parent is not self._root and parent.refs == 0
                    and not parent.children):
                heapq.heappush(heap,
                               (parent.last_used, id(parent), parent))
        return freed

    # ------------------------------------------------------------ defrag ----
    def remap(self, plan: Dict[int, int]) -> None:
        """Apply a ``PagePool.defrag_plan()`` to every cached node's page
        id (``apply_defrag`` rewrote the pools and the tables)."""
        if not plan:
            return
        for nd in self._nodes:
            nd.page = plan.get(nd.page, nd.page)

    def stats(self) -> Dict[str, int]:
        return {"cached_pages": self.cached_pages,
                "reusable_pages": self.reusable_pages,
                "evictions": self.evictions}
