"""FleetRouter: prefix-affinity request routing over engine replicas.

Port of ``paddle_tpu/serving/fleet/router.py``; its routing decisions
and counters equal the JAX router's on the same requests. Naive
round-robin over N replicas destroys the prefix cache's hit rate (each
session's next request lands on a cold trie with probability
(N-1)/N). The router keeps it by matching each prompt's leading-page
rolling-hash fingerprints (``prefix_cache.prefix_fingerprints``) against
every serving replica's hot-chain summary
(``PrefixCache.affinity_summary`` — same hash, same page framing): the
replica holding the DEEPEST matching chain gets the request, ties broken
by chain hotness, then by load. A prompt matching nobody is
rendezvous-hashed on its first page's fingerprint (so racing session
starts agree on one replica), and a prompt with no full page falls back
to least-loaded (queue depth + occupied slots from the replica health
gauges). A fingerprint collision can only mis-route; attachment still
compares the trie's exact token tuples.

Disaggregation is a routing policy, not an engine change: replicas
tagged ``prefill``/``decode`` split the traffic by each request's
prompt-vs-decode balance (``prefill_len_ratio``), ``general`` replicas
serve both pools, and an empty pool falls back to every candidate.
Affinity applies within the chosen pool; a chain the fleet migrated
(``note_migration``) routes its next turn to the adopting replica first.

Dispatch and re-dispatch: ``submit()`` builds the ``Request`` ROUTER-side,
so the same object (with its stream and done event) can move between
engines. ``redispatch()`` is exactly-once per request id: a request whose
second home ALSO drains is failed, not bounced forever.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..locktrace import fuzz_point, wrap_lock
from ..prefix_cache import prefix_fingerprints
from ..scheduler import CANCELLED, Request, RequestHandle
from .replica import ROLE_DECODE, ROLE_GENERAL, ROLE_PREFILL, Replica

__all__ = ["FleetRouter"]

POLICIES = ("affinity", "least_loaded", "round_robin")


def _rendezvous(fp: int, name: str) -> int:
    """Highest-random-weight score of (prefix fingerprint, replica):
    deterministic, dependency-free, and stable under membership change
    for every prefix whose winner survives."""
    h = fp & 0xFFFFFFFFFFFFFFFF
    for ch in name:
        h = (h * 1000003 + ord(ch) + 1) & 0xFFFFFFFFFFFFFFFF
    # one xorshift round decorrelates adjacent fingerprints
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    return h


class FleetRouter:
    """Routes ``submit()`` calls across :class:`Replica` instances.

    policy: ``affinity`` (default — fingerprint match, least-loaded
    fallback), ``least_loaded``, or ``round_robin`` (the control arm
    the fleet bench A/Bs against; it deliberately ignores warmth).
    summary_depth: how many leading pages the affinity fingerprints
    cover (2 catches system-prompt + few-shot-header sharing without
    walking deep tries).
    summary_ttl_s: per-replica affinity-summary cache lifetime. The
    summary is a tick-lock-protected trie walk on the replica, so the
    router refreshes it at most every TTL rather than per submit; a
    slightly stale summary costs at most a few cold routes after a
    chain first lands, never correctness.
    prefill_len_ratio: a request is classed prefill-heavy when
    ``prompt_tokens >= ratio * max_new_tokens`` (only consulted when
    role-tagged replicas exist).
    """

    def __init__(self, replicas: Iterable[Replica] = (), *,
                 policy: str = "affinity", summary_depth: int = 2,
                 summary_ttl_s: float = 0.05,
                 prefill_len_ratio: float = 1.0):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.summary_depth = int(summary_depth)
        self.summary_ttl_s = float(summary_ttl_s)
        self.prefill_len_ratio = float(prefill_len_ratio)
        self._lock = wrap_lock(threading.Lock(), "FleetRouter._lock")
        self._replicas: List[Replica] = list(replicas)
        self._rr = 0
        # id -> Request already re-dispatched once (exactly-once
        # dedup); finished entries are pruned on every redispatch()
        # call — dedup only has to protect LIVE requests, so the map
        # stays bounded by in-flight hand-backs, not fleet lifetime
        self._redispatched: Dict[int, Request] = {}
        # name -> (expiry_monotonic, summary dict)
        self._summaries: Dict[str, Tuple[float, dict]] = {}
        # name -> (expiry_monotonic, load): Replica.load() reads engine
        # gauges under the engine's TICK lock — the lock the worker
        # holds across a whole tick — so uncached reads would
        # serialize every submit against in-flight decode ticks
        # (same reason the affinity summary is TTL-cached)
        self._loads: Dict[str, Tuple[float, float]] = {}
        # fp -> replica name: chains the fleet MIGRATED (router-driven
        # prefill->decode handoff). Consulted before the TTL-cached
        # summaries in _pick, because a summary can be up to one TTL
        # stale — without this, a session's next turn raced the cache
        # refresh and re-landed on the prefill worker it just left.
        # Bounded LRU: correctness never depends on an evicted entry
        # (the adopting replica's own summary advertises the chain).
        self._migrated: "OrderedDict[int, str]" = OrderedDict()
        self._migrated_cap = 4096
        self.counters = {"routed_affinity": 0, "routed_hash": 0,
                         "routed_migrated": 0,
                         "routed_fallback": 0, "routed_round_robin": 0,
                         "redispatched": 0, "redispatch_failed": 0,
                         "rejected": 0}

    # -------------------------------------------------------- membership ----
    def add(self, replica: Replica) -> None:
        with self._lock:
            if all(r.name != replica.name for r in self._replicas):
                self._replicas.append(replica)

    def remove(self, name: str) -> None:
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r.name != name]
            self._summaries.pop(name, None)
            self._loads.pop(name, None)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def note_migration(self, fps: Sequence[int], name: str) -> None:
        """Record that the chain behind ``fps`` (its cumulative
        leading-page fingerprints) now lives on replica ``name`` — the
        migration policy calls this right after a successful handoff
        so the SESSION'S NEXT TURN routes to the adopting worker
        immediately, without waiting out the affinity-summary TTL."""
        with self._lock:
            for fp in fps:
                self._migrated.pop(int(fp), None)
                self._migrated[int(fp)] = str(name)
            while len(self._migrated) > self._migrated_cap:
                self._migrated.popitem(last=False)

    def _candidates(self, exclude: Sequence[str] = ()) -> List[Replica]:
        return [r for r in self.replicas()
                if r.serving and r.name not in exclude]

    # ----------------------------------------------------------- scoring ----
    def _summary(self, rep: Replica) -> dict:
        now = time.monotonic()
        with self._lock:
            ent = self._summaries.get(rep.name)
            if ent is not None and ent[0] > now:
                return ent[1]
        summ = rep.affinity_summary(self.summary_depth)
        with self._lock:
            self._summaries[rep.name] = (now + self.summary_ttl_s, summ)
        return summ

    def _load(self, rep: Replica) -> float:
        """TTL-cached :meth:`Replica.load` (see ``_loads`` comment)."""
        now = time.monotonic()
        with self._lock:
            ent = self._loads.get(rep.name)
            if ent is not None and ent[0] > now:
                return ent[1]
        load = rep.load()
        with self._lock:
            self._loads[rep.name] = (now + self.summary_ttl_s, load)
        return load

    def _role_pool(self, req: Request,
                   cands: List[Replica]) -> List[Replica]:
        """Prefill/decode disaggregation: only active when role-tagged
        replicas exist; generals serve both pools; an empty pool falls
        back to every candidate (availability beats specialization)."""
        if all(r.role == ROLE_GENERAL for r in cands):
            return cands
        want = (ROLE_PREFILL if req.prompt.size
                >= self.prefill_len_ratio * req.max_new_tokens
                else ROLE_DECODE)
        pool = [r for r in cands if r.role in (want, ROLE_GENERAL)]
        return pool or cands

    def _pick(self, req: Request,
              cands: List[Replica]) -> List[Replica]:
        """Order candidates best-first for this request (the dispatch
        loop walks the order until a replica accepts)."""
        pool = self._role_pool(req, cands)
        rest = [r for r in cands if r not in pool]
        if self.policy == "round_robin":
            with self._lock:
                self._rr += 1
                i = self._rr % len(pool)
            self.counters_inc("routed_round_robin")
            ordered = pool[i:] + pool[:i]
            return ordered + rest
        by_load = sorted(pool, key=self._load)
        # snapshot one live engine handle for the pool geometry — a
        # concurrent drain may null any replica's engine between the
        # serving check and here (Replica accessors tolerate it; so
        # must we)
        eng = next((r.engine for r in pool if r.engine is not None),
                   None)
        if self.policy == "affinity" and req.prompt.size > 1 \
                and eng is not None:
            fps = prefix_fingerprints(req.prompt, eng.pool.page_size,
                                      self.summary_depth)
            # migrated chains first, deepest fingerprint wins: the
            # handoff just placed these pages — fresher than any
            # TTL-cached summary can be
            for d in range(len(fps) - 1, -1, -1):
                with self._lock:
                    home = self._migrated.get(fps[d])
                if home is None:
                    continue
                rep = next((r for r in pool if r.name == home), None)
                if rep is not None and rep.serving:
                    self.counters_inc("routed_migrated")
                    return ([rep] + [r for r in by_load if r is not rep]
                            + rest)
                break       # target left the pool: fall through
            best, best_key = None, None
            for r in by_load:
                summ = self._summary(r)
                # deepest matching chain wins; hit count breaks ties.
                # (last_used is deliberately NOT in the key: it is each
                # trie's PRIVATE tick counter, not comparable across
                # replicas.) A full tie keeps the first candidate —
                # by_load order, i.e. the less loaded replica.
                for d in range(len(fps) - 1, -1, -1):
                    ent = summ.get(fps[d])
                    if ent is not None:
                        key = (d + 1, ent["hits"])
                        if best_key is None or key > best_key:
                            best, best_key = r, key
                        break
            if best is not None:
                self.counters_inc("routed_affinity")
                return ([best] + [r for r in by_load if r is not best]
                        + rest)
            if fps:
                # no replica holds the chain YET: rendezvous-hash the
                # first-page fingerprint onto the pool, so every later
                # request sharing this prefix — including ones racing
                # in before the first one's pages are inserted —
                # lands on the SAME replica and builds one warm chain
                # instead of N cold ones. (Classic consistent-hash
                # prefix routing; replica churn only remaps the
                # prefixes whose anchor left.)
                anchor = max(pool, key=lambda r: _rendezvous(
                    fps[0], r.name))
                self.counters_inc("routed_hash")
                return ([anchor]
                        + [r for r in by_load if r is not anchor]
                        + rest)
        self.counters_inc("routed_fallback")
        return by_load + rest

    def counters_inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    # ---------------------------------------------------------- dispatch ----
    def _dispatch(self, req: Request,
                  exclude: Sequence[str] = ()) -> Optional[str]:
        """Route + inject; returns the accepting replica's name or
        None when no serving replica takes the request."""
        cands = self._candidates(exclude)
        if not cands:
            return None
        # schedule-fuzz window: candidates chosen, none injected yet —
        # a replica may drain/die between selection and inject
        fuzz_point("router.dispatch.picked")
        for rep in self._pick(req, cands):
            if rep.inject(req):
                # optimistically bump the TTL-cached load: within one
                # TTL window a burst must not see a frozen ordering
                # and pile onto one replica's unbounded queue
                with self._lock:
                    ent = self._loads.get(rep.name)
                    if ent is not None:
                        self._loads[rep.name] = (ent[0], ent[1] + 1.0)
                return rep.name
        return None

    def submit(self, prompt, max_new_tokens: int, *,
               eos_token_id: Optional[int] = None,
               timeout: Optional[float] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, seed: int = 0) -> RequestHandle:
        """Fleet-wide submit: same per-request contract as
        ``ServingEngine.submit`` (streaming handle, per-request
        sampling state, deadline), with the engine chosen by the
        routing policy. Raises RuntimeError when NO serving replica
        accepts the request."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      deadline_s=deadline, temperature=temperature,
                      top_p=top_p, top_k=top_k, seed=seed)
        placed = self._dispatch(req)
        if placed is None:
            self.counters_inc("rejected")
            raise RuntimeError(
                f"fleet rejected request ({req.prompt.size} prompt "
                f"tokens + {max_new_tokens} new): no serving replica "
                f"accepted it")
        return RequestHandle(req)

    def redispatch(self, reqs: Sequence[Request],
                   exclude: Sequence[str] = ()) -> Tuple[int, int]:
        """Re-dispatch drained/failed requests, EXACTLY ONCE per
        request id: a request seen here before — or one no survivor
        accepts — is failed (finalized CANCELLED with the error on
        the handle) instead of bounced around a shrinking fleet.
        Returns ``(placed, failed)``."""
        placed = failed = 0
        with self._lock:
            # prune finished entries: a finalized request can never be
            # re-dispatched again (the done-check below skips it), so
            # dedup only has to remember LIVE ones — this bounds the
            # map by in-flight hand-backs instead of fleet lifetime
            self._redispatched = {i: r for i, r in
                                  self._redispatched.items()
                                  if not r.done.is_set()}
        for req in reqs:
            if req.done.is_set():
                continue        # finished while the hand-back settled
            with self._lock:
                again = req.id in self._redispatched
                self._redispatched[req.id] = req
            # schedule-fuzz window: dedup recorded, dispatch pending
            fuzz_point("router.redispatch.window")
            home = None if again else self._dispatch(req, exclude)
            if home is None:
                req.error = RuntimeError(
                    f"request {req.id} dropped by fleet re-dispatch: "
                    + ("already re-dispatched once"
                       if again else "no surviving replica accepted it"))
                req.finish(CANCELLED)
                self.counters_inc("redispatch_failed")
                failed += 1
            else:
                self.counters_inc("redispatched")
                placed += 1
        return placed, failed
