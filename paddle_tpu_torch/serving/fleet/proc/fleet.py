"""ProcServingFleet: launcher + supervisor for process replicas.

Port of ``paddle_tpu/serving/fleet/proc/fleet.py``. The multi-process
twin of :class:`~paddle_tpu_torch.serving.fleet.fleet.ServingFleet`:
same FleetRouter (prefix-affinity routing needs no changes —
ProcReplica serves the identical surface), same generation-bumped
join/drain/kill lifecycle, same exactly-once re-dispatch — but each
replica is a spawned worker process owning its own PyTorch runtime and
CUDA context, so the replicas' host work runs on as many interpreters
as there are workers instead of time-slicing one GIL. On one card the
workers' kernels still share the device (no MPS: the contexts
time-slice it).

Supervision adds the path the in-process fleet could not have: a HARD
crash (worker SIGKILLed, OOMed, or dead of any cause) is detected by
the transport pump, converted into drain-on-failure — membership
pruned, generation bumped, every unfinished request the dead worker
held handed back and re-dispatched to survivors exactly once — and
the caller's handles simply keep streaming from the new worker
(emission dedup in ProcReplica pins exactly-once delivery).

KV-page migration (the disaggregation step): :meth:`migrate_chain`
pulls a completed chain's pages out of a prefill worker by trie
fingerprint (engine.export_chain) and pushes them into a decode
worker's pool/trie (engine.adopt_chain) over the transport — after
which requests sharing that prefix decode on the target with a warm
cache, bitwise-identical to having prefilled there. Pages cross as
pickled numpy chunks (bf16 as ``np.uint16`` bits) through the queues'
pipes, never as tensors (wire.py).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ...locktrace import wrap_lock
from ...metrics import merge_exposition
from ...scheduler import RequestHandle
from ..replica import (DRAINING, GONE, JOINING, ROLE_DECODE,
                       ROLE_GENERAL, ROLE_PREFILL, SERVING)
from ..router import FleetRouter, _rendezvous
from .replica import ProcReplica

__all__ = ["ProcServingFleet"]


class ProcServingFleet:
    """N worker processes + router + elastic membership.

    spec: the :class:`WorkerSpec` every worker is spawned from (same
    weights seed fleet-wide — re-dispatch depends on replicas being
    bitwise-identical decoders).
    """

    def __init__(self, spec, *, replicas: int = 2,
                 roles: Optional[List[str]] = None,
                 policy: str = "affinity", summary_depth: int = 2,
                 prefill_len_ratio: float = 1.0,
                 name_prefix: str = "w",
                 start_timeout: float = 180.0,
                 rpc_timeout: float = 30.0,
                 drain_timeout: float = 120.0,
                 health_ttl_s: Optional[float] = None,
                 health_rpc_timeout: float = 5.0,
                 auto_migrate: Optional[bool] = None,
                 migrate_chunk_pages: int = 1):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.spec = spec
        self._prefix = str(name_prefix)
        self._timeouts = (start_timeout, rpc_timeout, drain_timeout)
        self._health_rpc_timeout = float(health_rpc_timeout)
        self._lock = wrap_lock(threading.Lock(), "ProcServingFleet._lock")
        self._n = 0
        self.generation = 0
        self._replicas: Dict[str, ProcReplica] = {}
        self._leaving: set = set()
        router_kw = dict(policy=policy, summary_depth=summary_depth,
                         prefill_len_ratio=prefill_len_ratio)
        if health_ttl_s is not None:
            # staleness window for the router's TTL-cached summary/
            # load reads (WorkerSpec deployments tune this per fleet)
            router_kw["summary_ttl_s"] = float(health_ttl_s)
        self.router = FleetRouter(**router_kw)
        # router-driven prefill->decode handoff: ON by default exactly
        # when the fleet is disaggregated (both pools present) —
        # a chain completed on a prefill worker is then handed to a
        # rendezvous-chosen decode worker automatically, chunked so
        # neither tick loop stalls; explicit True/False overrides
        role_list = list(roles or ())
        if auto_migrate is None:
            auto_migrate = (ROLE_PREFILL in role_list
                            and ROLE_DECODE in role_list)
        self.auto_migrate = bool(auto_migrate)
        self.migrate_chunk_pages = max(1, int(migrate_chunk_pages))
        self._migrating: set = set()    # fps with a handoff in flight
        self.counters = {"joins": 0, "drains": 0, "kills": 0,
                         "crashes": 0, "handed_back": 0, "closed": 0,
                         "migrations": 0, "migration_failed": 0}
        # bring the initial fleet up CONCURRENTLY: spawn + engine
        # build + warm overlap across workers (they are separate
        # processes — this is the first place that buys real time)
        reps = []
        for i in range(replicas):
            role = roles[i % len(roles)] if roles else ROLE_GENERAL
            reps.append(self._make(role))
        errs: list = []

        def _start(rep):
            try:
                rep.start()
            except BaseException as e:     # noqa: BLE001
                errs.append((rep.name, e))
        ths = [threading.Thread(target=_start, args=(r,), daemon=True,
                                name=f"fleet-start-{r.name}")
               for r in reps]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        if errs:
            for rep in reps:
                try:
                    rep.close(drain=False)
                except Exception:
                    pass
            name, e = errs[0]
            raise RuntimeError(
                f"fleet bring-up failed at {name}: {e}") from e
        for rep in reps:        # join order = name order
            self.router.add(rep)
            self._inc("joins")

    # -------------------------------------------------------- membership ----
    def _inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def _make(self, role: str) -> ProcReplica:
        st, rt, dt = self._timeouts
        with self._lock:
            name = f"{self._prefix}{self._n}"
            self._n += 1
            self.generation += 1
            gen = self.generation
        rep = ProcReplica(name, self.spec, role=role, generation=gen,
                          on_death=self._on_crash,
                          on_event=self._on_event, start_timeout=st,
                          rpc_timeout=rt, drain_timeout=dt,
                          health_rpc_timeout=self._health_rpc_timeout)
        with self._lock:
            self._replicas[name] = rep
        return rep

    def replica(self, name: str) -> ProcReplica:
        with self._lock:
            return self._replicas[name]

    def replicas(self, state: Optional[str] = None
                 ) -> List[ProcReplica]:
        with self._lock:
            reps = list(self._replicas.values())
        if state is not None:
            reps = [r for r in reps if r.state == state]
        return reps

    def join(self, role: str = ROLE_GENERAL) -> ProcReplica:
        """Elastic join: spawn + build + open to the router."""
        rep = self._make(role)
        rep.start()
        self.router.add(rep)
        self._inc("joins")
        return rep

    def _leave(self, name: str, counter: str) -> List:
        rep = self.replica(name)
        with self._lock:
            if name in self._leaving or rep.state in (DRAINING, GONE):
                return []
            self._leaving.add(name)
        try:
            handed = rep.drain()
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
        """Graceful leave (drain protocol + re-dispatch)."""
        return self._leave(name, "drains")

    def kill(self, name: str) -> List:
        """Drain-on-failure, accounted as a kill (the bench's
        kill-one-replica scenario)."""
        return self._leave(name, "kills")

    def kill_hard(self, name: str, timeout: float = 30.0) -> None:
        """SIGKILL the worker process and WAIT until the crash path
        (detect -> hand back -> re-dispatch) has completed — the
        failure-injection entry the kill-mid-stream tests drive."""
        rep = self.replica(name)
        rep.kill_process()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if rep.state == GONE and \
                    all(r.name != name
                        for r in self.router.replicas()):
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"crash handling for {name} incomplete after {timeout}s")

    def _on_crash(self, rep: ProcReplica, handed: List) -> None:
        """Transport death callback: exactly-once crash accounting +
        hand-back re-dispatch (the supervisor's whole job)."""
        with self._lock:
            if rep.name in self._leaving:
                return
            self._leaving.add(rep.name)
        try:
            self.router.remove(rep.name)
            with self._lock:
                self.generation += 1
                self.counters["kills"] += 1
                self.counters["crashes"] += 1
            if handed:
                self._inc("handed_back", len(handed))
                self.router.redispatch(handed, exclude=(rep.name,))
        finally:
            with self._lock:
                self._leaving.discard(rep.name)

    # --------------------------------------------------------- admission ----
    def submit(self, prompt, max_new_tokens: int,
               **kw) -> RequestHandle:
        return self.router.submit(prompt, max_new_tokens, **kw)

    def generate(self, prompt, max_new_tokens: int, **kw):
        return self.submit(prompt, max_new_tokens, **kw).result()

    # --------------------------------------------------------- migration ---
    def migrate_chain(self, fp: int, src: str, dst: str,
                      max_depth: int = 64) -> Optional[dict]:
        """Move a completed chain's KV pages ``src`` -> ``dst`` by
        trie fingerprint. Returns the adopt stats
        (``{"matched_pages", "adopted_pages"}``) or None when ``src``
        does not hold the chain. The source KEEPS its copy (migration
        is replication — the trie refcounts make eviction safe on
        both sides independently).

        Since r17 the transfer is CHUNKED and decode-overlapped: the
        source pins the chain and streams ``migrate_chunk_pages``-page
        blobs between its ticks, the target scatters them as they
        arrive, and the trie graft happens only at the final commit —
        so neither worker's tick loop stalls longer than one chunk's
        gather/scatter, and a failure at any step leaves both tries
        exactly as they were (abort frees the target's staged pages,
        end releases the source's pins)."""
        s, d = self.replica(src), self.replica(dst)
        hdr = s.export_chain_begin(fp, max_depth)
        if hdr is None:
            return None
        try:
            st = d.adopt_chain_begin(
                {"page_size": hdr["page_size"],
                 "tokens": hdr["tokens"]})
            if st["aid"] is None:       # fully cached already
                return {"matched_pages": st["matched_pages"],
                        "adopted_pages": 0}
            try:
                total = len(hdr["tokens"])
                step = self.migrate_chunk_pages
                for i in range(st["matched_pages"], total, step):
                    ch = s.export_chain_chunk(
                        hdr["xid"], i, min(step, total - i))
                    d.adopt_chain_chunk(st["aid"], ch["start"],
                                        ch["k"], ch["v"])
                return d.adopt_chain_commit(st["aid"])
            except BaseException:
                try:
                    d.adopt_chain_abort(st["aid"])
                except Exception:
                    pass    # target may be the one that died
                raise
        finally:
            try:
                s.export_chain_end(hdr["xid"])
            except Exception:
                pass        # source may be the one that died

    def _on_event(self, rep: ProcReplica, kind: str,
                  payload: dict) -> None:
        """Worker event callback (transport pump thread). The policy:
        a chain COMPLETED on a prefill-pool worker is handed to the
        decode pool — target picked by rendezvous hash on the chain
        fingerprint (deterministic, stable under churn), transfer on a
        background thread (the pump must never block on a multi-rpc
        exchange), dedup by fingerprint so a burst of same-prefix
        completions migrates once."""
        if kind != "chain_complete" or not self.auto_migrate:
            return
        if rep.role != ROLE_PREFILL:
            return      # decode/general completions stay put
        fp = int(payload["fp"])
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
        threading.Thread(
            target=self._do_migrate, args=(fp, payload, rep, dst),
            daemon=True, name=f"migrate-{rep.name}-{dst.name}").start()

    def _do_migrate(self, fp: int, payload: dict, src: ProcReplica,
                    dst: ProcReplica) -> None:
        """One handoff, exactly-once semantics: success notes the new
        home with the router (next session turn routes there);
        failure of EITHER side mid-transfer is counted and abandoned —
        the chain is simply re-prefilled cold wherever the next turn
        lands, which is always correct (migration is replication, the
        trie never holds half a transfer)."""
        try:
            # the whole chain, however deep: the JAX fleet's fixed
            # 64-page search would skip a longer prompt's chain (65
            # pages at 1040 tokens and page 16) without a word
            depth = max(64, int(payload.get("pages", 0)))
            res = self.migrate_chain(fp, src.name, dst.name, depth)
            if res is not None:
                self._inc("migrations")
                self.router.note_migration(
                    payload.get("fps", [fp]), dst.name)
        except Exception:
            self._inc("migration_failed")
        finally:
            with self._lock:
                self._migrating.discard(fp)

    # ----------------------------------------------------- observability ----
    def arm_sentinels(self) -> None:
        for rep in self.replicas(SERVING):
            rep.arm_sentinel()

    def snapshot(self) -> dict:
        """Same shape as ServingFleet.snapshot — the bench's fleet
        mode consumes either interchangeably."""
        reps = {}
        for rep in self.replicas():
            h = rep.health()
            src = rep.snapshot_dict()
            if src is not None:
                c = src.get("counters", {})
                h["counters"] = {k: c.get(k, 0) for k in
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
        """ONE Prometheus scrape for the whole fleet, assembled from
        per-worker scrape TEXT: each live worker renders its own
        exposition in-process, the parent parse-merges them
        (metrics.merge_exposition) under ``{replica, role}`` labels
        stamped HERE — same one-TYPE-line-per-family and escape-once
        guarantees as the in-process fleet, now across a process
        boundary."""
        entries = []
        reps = self.replicas()
        for rep in reps:
            if rep.state == GONE:
                continue
            text = rep.expose_text()
            if text is not None:
                entries.append(({"replica": rep.name,
                                 "role": rep.role}, text, None))
        with self._lock:
            gen = self.generation
            fleet_g = {f"fleet_{k}": v
                       for k, v in self.counters.items()}
        fleet_g["fleet_generation"] = gen
        for state in (JOINING, SERVING, DRAINING, GONE):
            fleet_g[f"fleet_replicas_{state}"] = sum(
                1 for r in reps if r.state == state)
        for k, v in self.router.counters.items():
            fleet_g[f"router_{k}"] = v
        entries.append(({}, None, fleet_g))
        return merge_exposition(entries)

    # ---------------------------------------------------------- shutdown ----
    def close(self, drain: bool = True) -> None:
        """Full fleet shutdown: every replica's queued + running
        requests are served (no survivors to hand back to), workers
        exit, processes are joined. Concurrent across workers."""
        reps = [r for r in self.replicas()
                if r.state not in (DRAINING, GONE)]

        def _close(rep):
            try:
                rep.close(drain=drain, hand_back=False)
            except Exception:
                pass
        ths = [threading.Thread(target=_close, args=(r,), daemon=True,
                                name=f"fleet-close-{r.name}")
               for r in reps]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        for rep in reps:
            self.router.remove(rep.name)
        self._inc("closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
