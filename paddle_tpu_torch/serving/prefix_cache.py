"""Refcounted prefix cache over the paged KV pool.

Copy of ``paddle_tpu/serving/prefix_cache.py``: requests sharing a
prompt prefix attach the SAME physical KV pages instead of recomputing
it, so admission prefills only the uncached suffix.

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

- **Fingerprints.** A chain's fingerprint is a rolling 64-bit hash of
  its page token tuples (``prefix_fingerprints``, ``affinity_summary``):
  it routes requests and names chains for migration and the cold tier,
  but never aliases KV — attachment compares the tuples.
- **Cold tier.** With ``spill`` set, ``evict`` hands each node to it
  before the page is freed (the engine pages its KV out to a
  ``ColdTier`` in host RAM).

Single-threaded by design: the engine serializes every call under its
tick lock.
"""
from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = ["PrefixCache", "ColdTier", "prefix_fingerprints"]

# the rolling hash of the JAX package, on Python ints: the same chain
# has the same fingerprint in both packages
_FP_MUL = 1000003
_FP_MASK = (1 << 64) - 1


def _fp_extend(fp: int, toks) -> int:
    for t in toks:
        fp = (fp * _FP_MUL + int(t) + 1) & _FP_MASK
    return fp


def prefix_fingerprints(prompt, page_size: int, max_depth: int = 2):
    """Rolling-hash fingerprints of ``prompt``'s leading full pages,
    ``[fp(page0), fp(page0+page1), ...]``, at most ``max_depth`` of them
    and at most the ``(n-1)//page_size`` pages a ``PrefixCache`` could
    attach for this prompt. The same hash as
    :meth:`PrefixCache.affinity_summary`, so a match means the trie
    holds that exact chain (up to 64-bit collisions, which cost routing
    warmth, never correctness)."""
    ps = int(page_size)
    pages = min(max(0, (len(prompt) - 1) // ps), int(max_depth))
    out, fp = [], 0
    for i in range(pages):
        fp = _fp_extend(fp, prompt[i * ps:(i + 1) * ps])
        out.append(fp)
    return out


class ColdTier:
    """Bounded host-RAM store of evicted KV pages, keyed by chain
    fingerprint.

    With ``ServingEngine(cold_tier_bytes=N)``, each page that eviction
    frees is first copied here (torch CPU tensors ``[L, Hkv, 1, ps,
    Dh]``) under the fingerprint of the chain up to it. A later prompt
    whose warm trie match ends where a cold chain begins re-adopts the
    pages (``ServingEngine._rewarm_cold``) instead of recomputing them,
    bitwise-equal to a warm hit: the bytes stored are the bytes the
    device computed. Every entry carries its page's token tuple, which
    the rewarm compares with the prompt, so a fingerprint collision
    costs a missed rewarm, never aliased KV.

    LRU by BYTES: ``put`` drops the least recently touched entries until
    the new one fits; an entry larger than the whole budget is refused.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        # chain fp -> {"toks", "k", "v", "nbytes"} in LRU order
        self._by_fp: "OrderedDict[int, dict]" = OrderedDict()
        self.bytes = 0
        self.spills = 0       # pages paged out to host
        self.hits = 0         # pages re-adopted from host
        self.drops = 0        # pages LRU-dropped to fit the budget

    def __len__(self) -> int:
        return len(self._by_fp)

    def put(self, fp: int, toks: tuple, k, v) -> bool:
        """Store one evicted page's KV under its chain fingerprint;
        False when it can never fit the budget."""
        nbytes = int(k.nbytes) + int(v.nbytes)     # numel x element size
        if nbytes > self.max_bytes:
            return False
        old = self._by_fp.pop(int(fp), None)
        if old is not None:
            self.bytes -= old["nbytes"]
        while self._by_fp and self.bytes + nbytes > self.max_bytes:
            _, dropped = self._by_fp.popitem(last=False)
            self.bytes -= dropped["nbytes"]
            self.drops += 1
        self._by_fp[int(fp)] = {"toks": tuple(toks), "k": k, "v": v,
                                "nbytes": nbytes}
        self.bytes += nbytes
        self.spills += 1
        return True

    def get(self, fp: int) -> Optional[dict]:
        """Peek (and LRU-touch) one entry; None when absent."""
        ent = self._by_fp.get(int(fp))
        if ent is not None:
            self._by_fp.move_to_end(int(fp))
        return ent

    def pop(self, fp: int) -> Optional[dict]:
        """Remove one entry (the rewarm pops what it adopted: the KV is
        back on the device)."""
        ent = self._by_fp.pop(int(fp), None)
        if ent is not None:
            self.bytes -= ent["nbytes"]
            self.hits += 1
        return ent

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._by_fp), "bytes": self.bytes,
                "max_bytes": self.max_bytes, "spills": self.spills,
                "hits": self.hits, "drops": self.drops}


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
        # cold-tier hook: evict() calls ``spill(node)`` for every node it
        # frees, BEFORE the page returns to the pool; a raising spill
        # must not wedge eviction (admission depends on it)
        self.spill = None

    def nodes(self):
        """Snapshot list of every cached node (the invariants audit walks
        them)."""
        return list(self._nodes)

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
            if self.spill is not None:
                try:
                    self.spill(nd)
                except Exception:
                    pass    # the cold tier is best-effort; eviction isn't
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

    # -------------------------------------------------------- migration ----
    def chain_by_fingerprint(self, fp: int,
                             max_depth: int = 64) -> List[_Node]:
        """The cached chain (root side first) whose rolling hash equals
        ``fp``, at most ``max_depth`` pages deep; empty when none does.
        Node pages are the live ids (``remap`` rewrote them after a
        defrag). A collision can at worst export another chain than
        meant; the adopting side keys by the exported token tuples."""
        target = int(fp) & _FP_MASK
        stack = [(self._root, 0, 0, [])]
        while stack:
            node, cur, d, path = stack.pop()
            if d >= int(max_depth):
                continue
            for toks, child in node.children.items():
                cfp = _fp_extend(cur, toks)
                cpath = path + [child]
                if cfp == target:
                    return cpath
                stack.append((child, cfp, d + 1, cpath))
        return []

    def adopt_chain(self, tokens: List[tuple], pages: List[int],
                    start: int = 0) -> List[_Node]:
        """Graft a chain prefilled elsewhere: ``tokens`` are the whole
        chain's page token tuples, ``tokens[:start]`` already cached
        here, ``pages`` this pool's pages now holding the KV of
        ``tokens[start:]``. New nodes enter at refs 0, the state a
        locally prefilled chain reaches when its request retires."""
        node = self._root
        for tt in tokens[:start]:
            node = node.children[tuple(tt)]
        t = next(self._tick)
        out: List[_Node] = []
        for tt, page in zip(tokens[start:], pages):
            key = tuple(int(x) for x in tt)
            child = _Node(key, node, int(page), t)
            node.children[key] = child
            self._nodes.add(child)
            out.append(child)
            node = child
        return out

    def match_chain(self, tokens: List[tuple]) -> int:
        """How many leading page token tuples of ``tokens`` are cached."""
        return len(self.chain_nodes(tokens))

    def chain_nodes(self, tokens: List[tuple]) -> List[_Node]:
        """The cached node path matching a leading run of ``tokens``
        (root side first; possibly empty)."""
        node, out = self._root, []
        for tt in tokens:
            nxt = node.children.get(tuple(int(x) for x in tt))
            if nxt is None:
                break
            out.append(nxt)
            node = nxt
        return out

    def node_fingerprint(self, nd: _Node) -> int:
        """Rolling fingerprint of the chain root..``nd`` (the cold tier's
        key for the node's page)."""
        toks = []
        while nd is not None and nd.parent is not None:
            toks.append(nd.toks)
            nd = nd.parent
        fp = 0
        for tt in reversed(toks):
            fp = _fp_extend(fp, tt)
        return fp

    # ------------------------------------------------------------ defrag ----
    def remap(self, plan: Dict[int, int]) -> None:
        """Apply a ``PagePool.defrag_plan()`` to every cached node's page
        id (``apply_defrag`` rewrote the pools and the tables)."""
        if not plan:
            return
        for nd in self._nodes:
            nd.page = plan.get(nd.page, nd.page)

    # ---------------------------------------------------------- affinity ----
    def affinity_summary(self, max_depth: int = 2) -> Dict[int, Dict]:
        """``{fingerprint: {"depth", "hits", "refs", "last_used"}}`` for
        every cached chain up to ``max_depth`` pages deep, computed live
        from the trie: an evicted chain leaves it at once, and a defrag
        (which moves pages, not tokens) leaves it unchanged. ``hits``
        counts ``acquire()`` attachments only."""
        out: Dict[int, Dict] = {}
        frontier = [(self._root, 0, 0)]         # (node, fp, depth)
        while frontier:
            node, fp, d = frontier.pop()
            if d >= max_depth:
                continue
            for toks, child in node.children.items():
                cfp = _fp_extend(fp, toks)
                out[cfp] = {"depth": d + 1, "hits": child.hits,
                            "refs": child.refs,
                            "last_used": child.last_used}
                frontier.append((child, cfp, d + 1))
        return out

    def stats(self) -> Dict[str, int]:
        return {"cached_pages": self.cached_pages,
                "reusable_pages": self.reusable_pages,
                "evictions": self.evictions}
