"""Paged-KV invariant checker: a race-detector-style model of
PagePool + prefix-cache trie + scheduler state.

Copy of ``paddle_tpu/analysis/kv_invariants.py`` (numpy only; the
violation codes are the JAX checker's). The serving stack's correctness
rests on host-side bookkeeping that no kernel can check for itself: page
ownership, trie refcounts, dead-slot table rows. A single slipped
refcount aliases two requests onto one physical page and decode silently
cross-contaminates their KV — tokens still stream, nothing crashes. This
module re-derives every invariant from first principles against the
live state and reports each violation:

* **partition** — every non-trash page is in exactly ONE of: the pool
  free list, some live request's private pages, or the prefix-cache
  trie. No page in two places; no allocated page owned by nobody
  (leak).
* **refcounts** — each trie node's ``refs`` equals the number of live
  requests whose attached chain contains it; a page shared by two
  slots' table rows MUST be a cached node with refs ≥ 2 (the
  "no double-attach without a matching trie refcount" rule).
* **table rows** — a live slot's row is position-major: each attached
  trie node's page sits at its chain-depth position, every remaining
  non-trash position in order is a private page of the request,
  TRASH-padded; its length fits the row's capacity; entries are in
  pool range.
* **parked slots** — a request mid chunked-prefill is a DEAD slot: the
  scheduler row must be all-TRASH with length 0 (a single real entry
  there and the fused decode block reads and writes a row the scheduler
  thinks is dead), while the stashed real row must stay consistent with the
  request's pages.
* **trie shape** — parent/child links are mutually consistent and
  node pages are distinct (a duplicated page id inside the trie is the
  refcount bug one step before it becomes visible).
* **defrag closure** — a ``defrag_plan`` must be closed over every
  live reference source: scheduler rows, request page lists, PARKED
  stashed rows, and cached trie pages. A source the plan misses keeps
  pointing at a page whose KV just moved.

Everything is host-side dict/array walking — O(pages + slots·row) per
audit — run after every tick by ``ServingEngine(check_invariants=True)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

__all__ = ["Violation", "KVInvariantError", "audit_serving_state",
           "audit_defrag_plan", "audit_engine"]


@dataclass
class Violation:
    code: str        # stable machine-readable id, e.g. "page-aliased"
    message: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.message}"


class KVInvariantError(AssertionError):
    """Raised by ``assert_ok`` paths; carries the full violation list.
    ``context`` (optional) names the engine state the audit ran
    against — e.g. the serving geometry — so a violation report from a
    dead engine is actionable without reproducing the run."""

    def __init__(self, violations: List[Violation],
                 context: str = ""):
        self.violations = violations
        self.context = context
        msg = ("paged-KV invariant violation(s):\n  " +
               "\n  ".join(str(v) for v in violations))
        if context:
            msg += f"\n  [{context}]"
        super().__init__(msg)


def _row_list(row) -> List[int]:
    """Table row as a plain python int list (one C-level conversion —
    the audit runs per tick, so per-element ``int()`` casts are real
    overhead)."""
    return row.tolist() if isinstance(row, np.ndarray) \
        else [int(p) for p in row]


def _nz(row) -> List[int]:
    """Non-trash entries of a table row, in position order."""
    return [p for p in _row_list(row) if p != 0]


def _chain_depth(nd) -> int:
    """1-based chain depth of a trie node (token pages covered)."""
    d = 0
    while nd is not None and nd.parent is not None:
        d += 1
        nd = nd.parent
    return d


def audit_serving_state(pool, scheduler=None, prefix_cache=None,
                        prefill_queue=None, extra_refs=None,
                        extra_pages=None) -> List[Violation]:
    """Full audit of one serving stack's host-side state. Callers must
    hold whatever lock serializes mutation (the engine's tick lock);
    the checker only reads. ``prefill_queue=None`` means "unknown" —
    the parked-but-not-queued liveness check is skipped.

    ``extra_refs`` (``{id(node): count}``) are trie refcounts held by
    something OTHER than a live request's attached chain — the chunked
    migration protocol pins exported chains and adopt graft points for
    a transfer's lifetime; without declaring them the refcount-drift
    check would fire on every in-flight transfer. ``extra_pages``
    (``{page_id: label}``) are allocated pages owned by a pending
    chunked adopt — scattered into but not yet grafted into the trie —
    which the partition check must count as owned, not leaked."""
    v: List[Violation] = []
    extra_refs = extra_refs or {}
    total = pool.total_pages
    trash = pool.TRASH

    # ---- pool internal consistency ----------------------------------
    free_list = list(pool._free)
    free = set(free_list)
    if len(free) != len(free_list):
        v.append(Violation("pool-free-dup",
                           "pool free list contains duplicate ids"))
    if free != pool._free_set:
        v.append(Violation(
            "pool-free-desync",
            f"free list ({len(free_list)} ids) and membership set "
            f"({len(pool._free_set)}) disagree"))
    bad = [p for p in free if not 0 < p < total]
    if trash in free or bad:
        v.append(Violation(
            "pool-free-range",
            f"free list holds trash/out-of-range ids: "
            f"{sorted(bad) + ([trash] if trash in free else [])}"))

    # ---- ownership maps ---------------------------------------------
    # owner labels are (kind, ident) tuples, stringified only on a
    # violation: this path runs every engine tick and eager f-strings
    # per page were the measured hot spot
    owners: Dict[int, List] = {}

    def own(page: int, kind: str, ident) -> None:
        if page == trash:
            return
        owners.setdefault(int(page), []).append((kind, ident))

    def who_str(who) -> str:
        return ", ".join(f"{k}:{i}" for k, i in who)

    cached_nodes = []
    if prefix_cache is not None:
        cached_nodes = prefix_cache.nodes()
        for nd in cached_nodes:
            own(nd.page, "cache-node", nd.page)

    live_reqs = []
    if scheduler is not None:
        live_reqs = scheduler.occupied()
        for slot, req in live_reqs:
            for p in req.pages:
                own(p, "req-private", req.id)

    if extra_pages:
        for page, label in extra_pages.items():
            own(int(page), "pending-adopt", label)

    for page, who in owners.items():
        if not 0 < page < total:
            v.append(Violation(
                "page-range", f"page {page} (owned by {who_str(who)}) "
                f"is out of pool range 1..{total - 1}"))
            continue
        if len(who) > 1:
            v.append(Violation(
                "page-aliased",
                f"page {page} owned {len(who)}x: {who_str(who)} — two "
                f"owners will free/overwrite each other's KV"))
        if page in free:
            v.append(Violation(
                "page-free-owned",
                f"page {page} owned by {who_str(who)} is ALSO on the "
                f"free list — the next alloc() aliases it"))
    used = total - 1 - len(free)
    if used != len(owners):
        v.append(Violation(
            "page-leak",
            f"pool reports {used} allocated pages but only "
            f"{len(owners)} are owned by live requests or the prefix "
            f"cache — {used - len(owners)} leaked (or over-owned)"))

    # ---- trie shape + refcounts -------------------------------------
    if prefix_cache is not None:
        seen_pages: Dict[int, int] = {}
        for nd in cached_nodes:
            seen_pages[nd.page] = seen_pages.get(nd.page, 0) + 1
            parent = nd.parent
            if parent is None or parent.children.get(nd.toks) is not nd:
                v.append(Violation(
                    "trie-links",
                    f"cache node for page {nd.page} is not its "
                    f"parent's child under its own key"))
            if nd.refs < 0:
                v.append(Violation(
                    "refcount-negative",
                    f"cache node page {nd.page} has refs={nd.refs}"))
        for page, cnt in seen_pages.items():
            if cnt > 1:
                v.append(Violation(
                    "trie-page-dup",
                    f"page {page} appears in {cnt} trie nodes"))

        expected: Dict[int, int] = {}
        for slot, req in live_reqs:
            for nd in req.prefix_nodes:
                expected[id(nd)] = expected.get(id(nd), 0) + 1
        by_id = {id(nd): nd for nd in cached_nodes}
        for nd in cached_nodes:
            want = expected.get(id(nd), 0) + int(extra_refs.get(id(nd),
                                                                0))
            if nd.refs != want:
                v.append(Violation(
                    "refcount-drift",
                    f"cache node page {nd.page} has refs={nd.refs} "
                    f"but {want} live request(s) attach it"))
        for nid, cnt in expected.items():
            if nid not in by_id:
                v.append(Violation(
                    "attach-evicted",
                    "a live request attaches a node no longer in the "
                    "trie (evicted while pinned)"))

    # ---- table rows / parked slots ----------------------------------
    if scheduler is not None:
        tables = scheduler.tables
        lengths = scheduler.lengths
        ps = pool.page_size
        parked_ids = ({id(r) for _, r in prefill_queue}
                      if prefill_queue is not None else None)
        lengths_l = _row_list(lengths)
        row_users: Dict[int, int] = {}
        for slot, req in live_reqs:
            parked = req.table_row is not None
            if parked:
                if not req.prefilling:
                    v.append(Violation(
                        "parked-not-prefilling",
                        f"slot {slot} stashes a real row but request "
                        f"{req.id} is not mid-prefill"))
                sched_row = _nz(tables[slot])
                if sched_row:
                    v.append(Violation(
                        "parked-row-live",
                        f"parked slot {slot} scheduler row is not "
                        f"all-TRASH (entries {sched_row}) — the shared "
                        f"decode program will read/write real pages "
                        f"of a mid-prefill request"))
                if lengths_l[slot] != 0:
                    v.append(Violation(
                        "parked-length",
                        f"parked slot {slot} has length "
                        f"{lengths_l[slot]} != 0 — the decode block "
                        f"walks ceil(len/page) entries of a dead "
                        f"row"))
                row_ints = _row_list(req.table_row)
            else:
                row_ints = _row_list(tables[slot])
            if row_ints and not (0 <= min(row_ints)
                                 and max(row_ints) < total):
                v.append(Violation(
                    "row-range",
                    f"slot {slot} row has out-of-range page ids"))
            # chain nodes live at their chain-depth positions (token
            # order); every remaining non-trash position, in order, is
            # a private page. This stays true through insert()'s
            # adoption (adopted/duplicate pages interleave in token
            # order — the row is position-major, never list-order).
            chain_pos = {}
            for nd in req.prefix_nodes:
                chain_pos[_chain_depth(nd) - 1] = int(nd.page)
            bad_chain = [
                (j, page, row_ints[j] if j < len(row_ints) else None)
                for j, page in chain_pos.items()
                if j >= len(row_ints) or row_ints[j] != page]
            if bad_chain:
                v.append(Violation(
                    "row-chain-mismatch",
                    f"slot {slot}: attached chain pages not at their "
                    f"chain positions: {sorted(bad_chain)} "
                    f"(pos, want, got)"))
            if chain_pos:
                got = [p for p in row_ints if p != 0]
                private_got = [p for j, p in enumerate(row_ints)
                               if p != 0 and j not in chain_pos]
            else:
                got = private_got = [p for p in row_ints if p != 0]
            private_want = [int(p) for p in req.pages]
            if private_got != private_want:
                v.append(Violation(
                    "row-mismatch",
                    f"slot {slot} private row pages {private_got} != "
                    f"request's page list {private_want}"))
            # the row must FUND the tokens the scheduler thinks exist
            n_tok = lengths_l[slot]
            if n_tok > len(got) * ps:
                v.append(Violation(
                    "length-overflow",
                    f"slot {slot} length {n_tok} exceeds row capacity "
                    f"{len(got)} pages x {ps}"))
            if parked and parked_ids is not None \
                    and id(req) not in parked_ids:
                v.append(Violation(
                    "parked-not-queued",
                    f"slot {slot} is parked but not in the prefill "
                    f"queue — its prefill will never advance"))
            # cross-slot sharing tally (reuses this slot's row walk;
            # set() so a duplicated entry within one row counts once)
            for p in set(got):
                row_users[p] = row_users.get(p, 0) + 1

        # cross-slot sharing must be trie-backed with refs >= count
        cached_by_page = ({nd.page: nd for nd in cached_nodes}
                          if prefix_cache is not None else {})
        for page, cnt in row_users.items():
            if cnt < 2:
                continue
            nd = cached_by_page.get(page)
            if nd is None:
                v.append(Violation(
                    "share-uncached",
                    f"page {page} sits in {cnt} live slots' rows but "
                    f"is not a prefix-cache node — a private page got "
                    f"double-attached"))
            elif nd.refs < cnt:
                v.append(Violation(
                    "share-underref",
                    f"page {page} sits in {cnt} live slots' rows but "
                    f"its trie refcount is {nd.refs} — retirement "
                    f"will free KV another slot still reads"))
    return v


def audit_defrag_plan(plan: Dict[int, int], pool, scheduler=None,
                      prefix_cache=None) -> List[Violation]:
    """Check a ``PagePool.defrag_plan()`` is applicable AND closed over
    every live reference source (table rows, request page lists,
    parked stashed rows, cached trie pages) BEFORE anything is
    rewritten."""
    v: List[Violation] = []
    total = pool.total_pages
    free = set(pool.free_page_ids)
    used = set(range(1, total)) - free
    for old, new in plan.items():
        if not (0 < old < total and 0 < new < total):
            v.append(Violation(
                "defrag-range", f"plan entry {old}->{new} out of range"))
        if old not in used:
            v.append(Violation(
                "defrag-stale-src",
                f"plan moves page {old} which is not allocated — the "
                f"plan is stale (recompute after alloc/free)"))
    dests = set(plan.values())
    if dests & (used - set(plan)):
        v.append(Violation(
            "defrag-dest-live",
            f"plan destinations {sorted(dests & (used - set(plan)))} "
            f"hold live KV not being moved — the gather overwrites it"))

    # closure: every page id any live structure references must survive
    # the remap (be a non-source, or be remapped)
    referenced: Dict[int, str] = {}
    if scheduler is not None:
        for slot, req in scheduler.occupied():
            for p in req.pages:
                referenced[int(p)] = f"req{req.id}.pages"
            row = scheduler.effective_row(slot)
            for p in _nz(row):
                referenced.setdefault(int(p), f"slot{slot}.row")
    if prefix_cache is not None:
        for nd in prefix_cache.nodes():
            referenced.setdefault(int(nd.page), f"cache@{nd.page}")
    for page, src in sorted(referenced.items()):
        if page in free:
            v.append(Violation(
                "defrag-ref-freed",
                f"{src} references page {page} which is on the free "
                f"list"))
    # a plan is CLOSED when no referenced page is a move *destination*
    # of some other page unless it is itself moved away first — the
    # gather formulation handles ordering, so the real hazard is a
    # referenced page that the plan treats as free space
    for page, src in sorted(referenced.items()):
        if page in dests and page not in plan:
            v.append(Violation(
                "defrag-clobber",
                f"plan writes page {page} still referenced by {src} "
                f"without moving it first"))
    return v


def audit_engine(engine) -> List[Violation]:
    """Standalone audit of a live ``ServingEngine`` (grabs the tick
    lock so the state it reads is a consistent snapshot)."""
    with engine._tick_lock:
        extra_refs, extra_pages = engine._audit_extras()
        return audit_serving_state(
            engine.pool, engine.scheduler, engine.prefix_cache,
            prefill_queue=tuple(engine._prefill_q),
            extra_refs=extra_refs, extra_pages=extra_pages)
