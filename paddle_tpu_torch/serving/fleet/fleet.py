"""ServingFleet: N engine replicas + router + elastic membership.

Port of ``paddle_tpu/serving/fleet/fleet.py``: ``ServingEngine``
replicas (:class:`~.replica.Replica`: lifecycle + health) behind a
:class:`~.router.FleetRouter` (prefix affinity, prefill/decode
disaggregation, exactly-once re-dispatch), with the engines' metrics,
flight recorders and recompile sentinels aggregated.

Membership follows a GENERATION idiom: every join, drain and kill bumps
``fleet.generation``, and each replica records the generation it joined
at, so health views and the aggregated exposition say which fleet shape
a number belongs to.

Replicas are threads in one process. On a card they share one params
object and launch on the default stream, where their kernels interleave
in issue order (each thread's own launches stay in order; the replicas
share only read-only params). Every cross-replica interface is
process-shaped — plain-data health dicts, Prometheus text, fingerprint
dicts, handed-back request lists.

Failure handling is drain-on-failure: ``kill()`` runs the SAME drain
protocol as a graceful leave — stop admission, finish in-flight slots,
hand queued requests back — then re-dispatches the handed-back requests
through the router. No accepted request is dropped by a drain. The one
hole is a hard engine crash (the worker died mid-tick, e.g. on a
``KVInvariantError``): the engine's fail-fast contract errors those
handles at once (and writes its postmortem) rather than retry work whose
KV state is suspect; ``reap()`` then closes the replica out.

Prefill->decode handoff (``auto_migrate``, on when both pools exist): a
prefill replica's engine reports each completed prompt chain
(``on_chain_complete``, under its tick lock); a background thread moves
the chain with ``export_chain``/``adopt_chain`` to the decode replica
chosen by rendezvous hash, and the router sends the session's next turn
there.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..locktrace import fuzz_point, wrap_lock
from ..metrics import merge_exposition
from ..scheduler import RequestHandle
from .replica import (DRAINING, GONE, JOINING, ROLE_DECODE,
                      ROLE_GENERAL, ROLE_PREFILL, SERVING, Replica)
from .router import FleetRouter, _rendezvous

__all__ = ["ServingFleet"]


class ServingFleet:
    """N replicas behind a :class:`FleetRouter`.

        fleet = ServingFleet(lambda: ServingEngine(params, cfg, ...),
                             replicas=4)
        h = fleet.submit(prompt, max_new_tokens=16)
        toks = h.result()
        fleet.drain("r0")          # graceful leave; queued re-dispatch
        fleet.join(role="decode")  # elastic join, generation bumped
        fleet.close()

    engine_factory: zero-arg callable building ONE ServingEngine; each
    replica calls it once (share one params object between them).
    replicas: initial replica count. roles: optional per-replica role
    list (``general``/``prefill``/``decode``) cycled over the initial
    replicas — role-tagging turns on the router's prefill/decode
    disaggregation.
    policy / summary_depth / prefill_len_ratio: see FleetRouter.
    warm: warm each engine's kernel libraries at join (leave True — it
    is what makes the armed sentinels clean).
    """

    def __init__(self, engine_factory: Callable, *, replicas: int = 2,
                 roles: Optional[List[str]] = None,
                 policy: str = "affinity", summary_depth: int = 2,
                 prefill_len_ratio: float = 1.0, warm: bool = True,
                 name_prefix: str = "r",
                 health_ttl_s: Optional[float] = None,
                 auto_migrate: Optional[bool] = None):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self._factory = engine_factory
        self._prefix = str(name_prefix)
        self._lock = wrap_lock(threading.Lock(), "ServingFleet._lock")
        self._n = 0
        self.generation = 0
        self._replicas: Dict[str, Replica] = {}   # join order, ALL states
        self._leaving: set = set()      # names mid-_leave: makes the
        # leave accounting (generation bump + drain/kill counter)
        # exactly-once under concurrent drain/kill/reap of one replica
        router_kw = dict(policy=policy, summary_depth=summary_depth,
                         prefill_len_ratio=prefill_len_ratio)
        if health_ttl_s is not None:
            # router staleness window (summary/load TTL caches)
            router_kw["summary_ttl_s"] = float(health_ttl_s)
        self.router = FleetRouter(**router_kw)
        # router-driven prefill->decode handoff: defaults ON exactly
        # when both pools exist
        role_list = list(roles or ())
        if auto_migrate is None:
            auto_migrate = (ROLE_PREFILL in role_list
                            and ROLE_DECODE in role_list)
        self.auto_migrate = bool(auto_migrate)
        self._migrating: set = set()
        self.counters = {"joins": 0, "drains": 0, "kills": 0,
                         "handed_back": 0, "closed": 0,
                         "migrations": 0, "migration_failed": 0}
        for i in range(replicas):
            role = roles[i % len(roles)] if roles else ROLE_GENERAL
            self.join(role=role, warm=warm)

    # -------------------------------------------------------- membership ----
    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def replica(self, name: str) -> Replica:
        with self._lock:
            return self._replicas[name]

    def replicas(self, state: Optional[str] = None) -> List[Replica]:
        with self._lock:
            reps = list(self._replicas.values())
        if state is not None:
            reps = [r for r in reps if r.state == state]
        return reps

    def join(self, role: str = ROLE_GENERAL, *,
             warm: bool = True) -> Replica:
        """Elastic join: bump the generation, build + warm the engine,
        open it to the router. Returns the new replica."""
        with self._lock:
            name = f"{self._prefix}{self._n}"
            self._n += 1
            self.generation += 1
            gen = self.generation
        rep = Replica(name, self._factory, role=role, generation=gen)
        with self._lock:
            self._replicas[name] = rep
        rep.start(warm=warm)
        if self.auto_migrate and role == ROLE_PREFILL \
                and rep.engine is not None:
            # wire the engine's chain-completion hook to the fleet's
            # migration policy; the hook fires under the engine's tick
            # lock, so it must only capture the event — the transfer
            # runs on a background thread (_on_chain_complete)
            rep.engine.on_chain_complete = (
                lambda req, info, _rep=rep:
                self._on_chain_complete(_rep, info))
        self.router.add(rep)
        self._inc("joins")
        return rep

    def _leave(self, name: str, counter: str) -> List:
        rep = self.replica(name)
        with self._lock:
            # exactly-once accounting: concurrent drain/kill/reap of
            # one replica (and post-completion retries) are ONE leave
            if name in self._leaving or rep.state in (DRAINING, GONE):
                return []
            self._leaving.add(name)
        try:
            # flip to DRAINING through the replica itself so the
            # router stops selecting it the moment the leave begins
            handed = rep.drain()
            # schedule-fuzz window: the handed-back queue exists but
            # is not yet re-dispatched — the exactly-once seam
            fuzz_point("fleet.leave.handed")
            # prune the router's membership + TTL caches: a GONE
            # replica must not cost every future submit a filter pass
            self.router.remove(name)
            with self._lock:
                self.generation += 1
                self.counters[counter] += 1
            if handed:
                self._inc("handed_back", len(handed))
                self.router.redispatch(handed, exclude=(name,))
            return handed
        finally:
            with self._lock:
                self._leaving.discard(name)

    def drain(self, name: str) -> List:
        """Graceful leave: drain protocol + re-dispatch of the
        handed-back queue to survivors. Returns the handed-back
        requests (already re-dispatched — callers usually just want
        the count)."""
        return self._leave(name, "drains")

    def kill(self, name: str) -> List:
        """Drain-on-failure: identical mechanics to :meth:`drain`
        (stop admission, finish in-flight, hand back + re-dispatch
        queued) but accounted as a failure — the kill-one-replica
        bench scenario and any health sweep reaping a sick replica go
        through here."""
        return self._leave(name, "kills")

    def reap(self) -> List[str]:
        """Health sweep: drain-on-failure for every replica whose
        engine worker died (their queued requests were already failed
        by the engine's fail-fast contract; this closes them out and
        bumps the generation so the fleet shape is honest). Returns
        the reaped names."""
        reaped = []
        for rep in self.replicas():
            if rep.state in (SERVING, JOINING) and rep.engine is not None \
                    and not rep.alive:
                self.kill(rep.name)
                reaped.append(rep.name)
        return reaped

    # --------------------------------------------------------- migration ---
    def migrate_chain(self, fp: int, src: str, dst: str,
                      max_depth: int = 64) -> Optional[dict]:
        """Move a completed chain's KV pages ``src`` -> ``dst`` by trie
        fingerprint (engines share an address space, so the transfer is
        one export + one adopt). The source keeps its copy
        — migration is replication."""
        s = self.replica(src).engine
        d = self.replica(dst).engine
        if s is None or d is None:
            return None
        blob = s.export_chain(fp, max_depth)
        if blob is None:
            return None
        return d.adopt_chain(blob)

    def _on_chain_complete(self, rep: Replica, info: dict) -> None:
        """Chain-completion hook (fires under ``rep``'s engine tick
        lock): pick the decode-pool target by rendezvous hash and run
        the handoff on a background thread — export_chain re-takes the
        source's tick lock, so migrating inline would deadlock."""
        fp = int(info["fp"])
        with self._lock:
            if fp in self._migrating:
                return
            self._migrating.add(fp)
        pool = [r for r in self.router.replicas()
                if r.serving and r.role == ROLE_DECODE
                and r.name != rep.name]
        if not pool:
            with self._lock:
                self._migrating.discard(fp)
            return
        dst = max(pool, key=lambda r: _rendezvous(fp, r.name))
        # the whole chain, however deep: the JAX fleet's fixed 64-page
        # search would skip a longer prompt's chain (65 pages at 1040
        # tokens and page 16) without a word
        depth = max(64, int(info.get("pages", 0)))

        def _go():
            try:
                res = self.migrate_chain(fp, rep.name, dst.name, depth)
                if res is not None:
                    self._inc("migrations")
                    self.router.note_migration(
                        info.get("fps", [fp]), dst.name)
            except Exception:
                self._inc("migration_failed")
            finally:
                with self._lock:
                    self._migrating.discard(fp)
        threading.Thread(target=_go, daemon=True,
                         name=f"migrate-{rep.name}-{dst.name}").start()

    # --------------------------------------------------------- admission ----
    def submit(self, prompt, max_new_tokens: int,
               **kw) -> RequestHandle:
        """Route one request into the fleet (see FleetRouter.submit)."""
        return self.router.submit(prompt, max_new_tokens, **kw)

    def generate(self, prompt, max_new_tokens: int, **kw):
        """Blocking convenience: submit + wait (engine parity)."""
        return self.submit(prompt, max_new_tokens, **kw).result()

    # ----------------------------------------------------- observability ----
    def arm_sentinels(self) -> None:
        """Declare fleet warmup done: any later kernel library load
        trips the per-replica recompile sentinels (engine.arm_sentinel).
        Call after every replica joined and warmed — libraries load once
        a process, so an elastic join AFTER arming stays clean too."""
        for rep in self.replicas(SERVING):
            eng = rep.engine        # tolerate a concurrent drain
            if eng is not None:     # nulling the handle mid-walk
                eng.arm_sentinel()

    def snapshot(self) -> dict:
        """Fleet-level plain-dict view: generation, per-replica health
        (+ key lifecycle counters), router counters, fleet counters."""
        reps = {}
        for rep in self.replicas():
            h = rep.health()
            eng = rep.engine
            src = rep.final_snapshot() if eng is None \
                else eng.snapshot()
            if src is not None:
                c = src["counters"]
                h["counters"] = {k: c[k] for k in
                                 ("submitted", "admitted", "completed",
                                  "handed_back", "tokens_out",
                                  "prefix_hits", "prefix_misses")}
            reps[rep.name] = h
        with self._lock:
            counters = dict(self.counters)
            gen = self.generation
        return {"generation": gen, "policy": self.router.policy,
                "replicas": reps, "router": dict(self.router.counters),
                "fleet": counters}

    def expose(self) -> str:
        """ONE Prometheus scrape for the whole fleet: every live
        replica's counters/histograms/gauges labeled
        ``{replica, role}`` (escape-once structured merging —
        metrics.merge_exposition), plus fleet-level gauges
        (generation, membership, router counters)."""
        entries = []
        reps = self.replicas()      # ONE membership snapshot: the
        # scrape's per-state counts and per-replica samples must
        # describe the same instant, and a replica whose engine a
        # concurrent drain nulls mid-scrape degrades to omission, not
        # a crashed endpoint
        for rep in reps:
            eng = rep.engine
            if eng is None or rep.state == GONE:
                continue
            labels = {"replica": rep.name, "role": rep.role}
            try:
                entries.append((labels, eng.metrics, eng.gauges()))
            except Exception:
                entries.append((labels, eng.metrics, None))
        with self._lock:
            gen = self.generation
            fleet_g = {f"fleet_{k}": v for k, v in self.counters.items()}
        fleet_g["fleet_generation"] = gen
        for state in (JOINING, SERVING, DRAINING, GONE):
            fleet_g[f"fleet_replicas_{state}"] = sum(
                1 for r in reps if r.state == state)
        for k, v in self.router.counters.items():
            fleet_g[f"router_{k}"] = v
        entries.append(({}, None, fleet_g))
        return merge_exposition(entries)

    def flight_view(self, last: int = 8) -> dict:
        """Fleet-level flight view: each replica's lifecycle state plus
        its flight recorder's last ``last`` tick records — the
        postmortem-shaped answer to "what was every replica doing just
        now", GONE replicas included (their recorders survive the
        engine close)."""
        out = {}
        for rep in self.replicas():
            out[rep.name] = {
                "state": rep.state, "role": rep.role,
                "generation": rep.generation,
                "ticks": rep.flight_ticks()[-last:],
                "postmortem": rep.postmortem_path}
        return out

    # ----------------------------------------------------------- shutdown ----
    def close(self, drain: bool = True) -> None:
        """Shut the whole fleet down. drain=True finishes every
        replica's queued + running requests (full engine drain — with
        no survivors there is nobody to hand a queue back to);
        drain=False cancels everything. Goes through
        ``Replica.close`` so the lifecycle state machine, its
        idempotence guard (a concurrent drain/reap cannot double-close
        an engine) and the GONE-replica snapshot/sentinel capture hold
        on this path too."""
        for rep in self.replicas():
            rep.close(drain=drain, hand_back=False)
        self._inc("closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
