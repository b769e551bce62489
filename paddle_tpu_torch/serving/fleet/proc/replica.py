"""ProcReplica: the Replica API served by a worker PROCESS.

Port of ``paddle_tpu/serving/fleet/proc/replica.py``. The in-process
:class:`~paddle_tpu_torch.serving.fleet.replica.Replica` was
deliberately process-shaped — health dicts, Prometheus text,
fingerprint summaries, handed-back request lists, all plain data. This
class is the payoff: the same lifecycle states, the same drain
protocol, the same router-facing surface (``serving``/``inject``/
``load``/``affinity_summary``), but the engine lives in a spawned
worker behind a :class:`WorkerTransport`, so N replicas run on N
Python runtimes (each with its own CUDA context) instead of sharing
one GIL.

The parent-side Request stays authoritative: ``inject`` ships only the
request's parameters (wire.py) and keeps the caller's stream/done
machinery here, fed by the transport's ``tok``/``done`` frames. That
is what makes hand-off invisible to callers — on drain OR crash, an
unfinished request is simply re-dispatched (by the fleet, through the
same FleetRouter) and its handle keeps yielding tokens from the new
worker.

Exactly-once emission across re-dispatch: at inject time the replica
records ``skip = len(req.tokens)`` — the tokens the caller has already
seen from a previous worker. A fresh worker re-decodes the stream from
the start (identical weights + greedy/fixed-seed sampling make the
prefix bitwise-identical), and the frame relay DROPS the first
``skip`` frames, so the handle sees every token exactly once however
many times the request moves.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ...locktrace import wrap_lock

from ..replica import (DRAINING, GONE, JOINING, ROLE_GENERAL, SERVING,
                       _ROLES)
from .transport import TransportError, WorkerTransport
from .wire import check_plain, request_to_wire

__all__ = ["ProcReplica"]


class _PoolShim:
    def __init__(self, page_size: int):
        self.page_size = int(page_size)


class _EngineShim:
    """What FleetRouter._pick dereferences for pool geometry
    (``r.engine.pool.page_size``) — the only engine attribute the
    router consumes directly."""
    def __init__(self, page_size: int):
        self.pool = _PoolShim(page_size)


class ProcReplica:
    _CC_LOCK_FREE_READS = {
        "state": "single opaque string replaced atomically under "
                 "_lock; health/load readers accept one stale "
                 "transition by design (the router re-polls)",
        "_t": "transport ref is written once at start() and cleared "
              "only by kill_process(); readers bind t = self._t once "
              "and a cleared ref degrades to a dead-replica refusal",
        "_max_batch": "written once when the worker's ready frame "
                      "lands; load() reading the pre-ready default "
                      "just overestimates pressure for one poll",
    }

    def __init__(self, name: str, spec, *, role: str = ROLE_GENERAL,
                 generation: int = 0,
                 on_death: Optional[Callable] = None,
                 on_event: Optional[Callable] = None,
                 start_timeout: float = 180.0,
                 rpc_timeout: float = 30.0,
                 drain_timeout: float = 120.0,
                 health_rpc_timeout: float = 5.0):
        if role not in _ROLES:
            raise ValueError(f"role must be one of {_ROLES}, "
                             f"got {role!r}")
        self.name = str(name)
        self.role = role
        self.generation = int(generation)
        self.spec = spec
        self.state = JOINING
        self.engine: Optional[_EngineShim] = None
        self._t: Optional[WorkerTransport] = None
        # out-of-band worker events, called as on_event(replica, kind,
        # payload) from the transport pump thread — the fleet's
        # migration policy listens for "chain_complete" here
        self._on_event_cb = on_event
        # staleness window for the health-poll rpcs (health/load/
        # affinity): how long the router may wait on a wedged worker
        # before treating it as unhealthy — tunable per deployment
        # through the fleet ctor (health_ttl_s governs how often these
        # fire; this governs how long each may hang)
        self._health_rpc_timeout = float(health_rpc_timeout)
        self._lock = wrap_lock(threading.RLock(), "ProcReplica._lock")
        # rid -> [req, skip, cancel_sent]
        self._outstanding: dict = {}
        self._on_death_cb = on_death
        self._start_timeout = float(start_timeout)
        self._rpc_timeout = float(rpc_timeout)
        self._drain_timeout = float(drain_timeout)
        self._max_batch = 1
        self._final_snapshot: Optional[dict] = None
        self._final_sentinel: Optional[dict] = None

    def __repr__(self):
        return (f"ProcReplica({self.name!r}, role={self.role}, "
                f"state={self.state}, pid={self.pid})")

    # -------------------------------------------------------- lifecycle ----
    def start(self) -> "ProcReplica":
        with self._lock:
            if self.state != JOINING:
                raise RuntimeError(
                    f"replica {self.name} cannot start from state "
                    f"{self.state}")
        t = WorkerTransport(self.spec, name=self.name,
                            start_timeout=self._start_timeout,
                            on_frame=self._frame,
                            on_death=self._death,
                            on_event=self._event)
        with self._lock:
            self._t = t
            self.engine = _EngineShim(t.ready["page_size"])
            self._max_batch = int(t.ready["max_batch"])
            self.state = SERVING
        return self

    def drain(self) -> List:
        """The drain protocol over the transport: worker stops
        admission, finishes in-flight slots, hands back its queue; the
        returned parent-side Requests are still QUEUED for the fleet
        to re-dispatch. Idempotent."""
        return self.close(drain=True, hand_back=True)

    def close(self, drain: bool = True,
              hand_back: bool = False) -> List:
        with self._lock:
            if self.state in (DRAINING, GONE):
                return []
            self.state = DRAINING
            t = self._t
        handed_rids: List[int] = []
        if t is not None and t.alive:
            t.expect_exit()
            try:
                r = t.rpc("shutdown",
                          {"drain": drain, "hand_back": hand_back},
                          timeout=self._drain_timeout)
                handed_rids = list(r.get("handed") or [])
                self._final_snapshot = r.get("snapshot")
                self._final_sentinel = r.get("sentinel")
            except TransportError:
                pass        # worker died mid-drain: everything still
                #             outstanding is handed back below
        handed: List = []
        with self._lock:
            for rid in handed_rids:
                ent = self._outstanding.pop(rid, None)
                if ent is not None and not ent[0].done.is_set():
                    handed.append(ent[0])
            # non-handed requests finished inside the worker's drain,
            # and their done frames were queued BEFORE the shutdown
            # reply (worker joins relays first) — so anything still
            # unresolved here means the worker died: hand it back too
            for rid, ent in list(self._outstanding.items()):
                if not ent[0].done.is_set():
                    handed.append(ent[0])
                self._outstanding.pop(rid, None)
        if t is not None:
            t.stop()
        with self._lock:
            self.state = GONE
        return handed

    def kill_process(self) -> None:
        """SIGKILL the worker — the crash-injection path. Detection,
        hand-back and re-dispatch run through the transport's death
        callback, same as any real crash."""
        t = self._t
        if t is not None:
            t.kill()

    # ----------------------------------------------------- frame handling --
    def _frame(self, msg) -> None:
        kind = msg[0]
        if kind == "tok":
            _, rid, fseq, tok = msg
            with self._lock:
                ent = self._outstanding.get(rid)
            if ent is None:
                return
            req, skip, cancel_sent = ent
            if fseq < skip:
                return      # re-dispatch dedup: caller saw this token
                #             from a previous worker already
            if req.cancel_flag and not cancel_sent:
                ent[2] = True
                t = self._t
                if t is not None:
                    t.cast("cancel", {"rid": rid})
            if req.first_token_t is None:
                req.first_token_t = time.monotonic()
            req.tokens.append(int(tok))
            req.stream.put(int(tok))
        elif kind == "done":
            _, rid, fseq, state, err = msg
            with self._lock:
                ent = self._outstanding.pop(rid, None)
            if ent is None:
                return
            req = ent[0]
            if err:
                req.error = RuntimeError(
                    f"replica {self.name}: {err}")
            req.finish(state)

    def _event(self, kind: str, payload: dict) -> None:
        """Out-of-band worker event (pump thread) — forward with this
        replica as the source so the fleet policy knows which worker's
        chain completed."""
        cb = self._on_event_cb
        if cb is not None:
            cb(self, kind, payload)

    def _death(self) -> None:
        """Transport death callback (pump thread): the worker crashed.
        Every unfinished outstanding request is handed back to the
        fleet exactly once (finished ones already resolved — the pump
        drained their frames before declaring death)."""
        with self._lock:
            if self.state == GONE:
                ents = []
            else:
                self.state = GONE
                ents = list(self._outstanding.values())
                self._outstanding.clear()
        handed = [e[0] for e in ents if not e[0].done.is_set()]
        cb = self._on_death_cb
        if cb is not None:
            cb(self, handed)

    # --------------------------------------------------------- admission ----
    def inject(self, req) -> bool:
        """Router dispatch path: ship the request's parameters, keep
        the caller's handle here. Registered BEFORE the rpc so frames
        racing the accept reply are never dropped."""
        with self._lock:
            if self.state != SERVING:
                return False
            t = self._t
        if t is None or not t.alive:
            return False
        skip = len(req.tokens)
        with self._lock:
            self._outstanding[req.id] = [req, skip, False]
        try:
            r = t.rpc("inject", request_to_wire(req),
                      timeout=self._rpc_timeout)
            accepted = bool(r.get("accepted"))
        except TransportError:
            accepted = False
        if not accepted:
            with self._lock:
                self._outstanding.pop(req.id, None)
        return accepted

    # ----------------------------------------------------------- health ----
    @property
    def alive(self) -> bool:
        t = self._t
        return t is not None and t.alive

    @property
    def serving(self) -> bool:
        return self.state == SERVING and self.alive

    @property
    def pid(self) -> Optional[int]:
        t = self._t
        return t.pid if t is not None else None

    def _rpc(self, op: str, payload: Optional[dict] = None, *,
             timeout: Optional[float] = None):
        t = self._t
        if t is None:
            raise TransportError(f"replica {self.name} has no worker")
        return t.rpc(op, payload,
                     timeout=timeout or self._rpc_timeout)

    def health(self) -> dict:
        h = {"name": self.name, "role": self.role,
             "state": self.state, "generation": self.generation,
             "alive": self.alive, "pid": self.pid}
        if self.state == GONE or not h["alive"]:
            if self._final_snapshot is not None:
                h["gauges"] = {
                    k: v for k, v in
                    self._final_snapshot.get("gauges", {}).items()
                    if isinstance(v, (int, float))}
            return h
        try:
            h["gauges"] = self._rpc(
                "gauges", timeout=self._health_rpc_timeout)
        except TransportError:
            h["alive"] = False
        return h

    def load(self) -> float:
        """Same scalar as Replica.load (queued + occupancy * batch);
        the router TTL-caches it, so this costs ONE rpc per TTL
        window, not one per submit."""
        if self.state != SERVING or not self.alive:
            return float("inf")
        try:
            g = self._rpc("gauges",
                          timeout=self._health_rpc_timeout)
        except TransportError:
            return float("inf")
        return float(g.get("queued", 0)
                     + g.get("occupancy", 0.0) * self._max_batch)

    def affinity_summary(self, max_depth: int = 2) -> dict:
        if self.state != SERVING or not self.alive:
            return {}
        try:
            return self._rpc("affinity", {"max_depth": max_depth},
                             timeout=self._health_rpc_timeout)
        except TransportError:
            return {}

    def sentinel_report(self) -> Optional[dict]:
        if self._final_sentinel is not None:
            return self._final_sentinel
        if not self.alive:
            return None
        try:
            return self._rpc("sentinel_report")
        except TransportError:
            return None

    def arm_sentinel(self) -> None:
        try:
            self._rpc("arm_sentinel")
        except TransportError:
            pass

    def expose_text(self) -> Optional[str]:
        """The worker's OWN Prometheus scrape text — the fleet merges
        it (metrics.merge_exposition parse-merge path) under
        ``{replica, role}`` labels stamped parent-side."""
        if not self.alive:
            return None
        try:
            return self._rpc("expose")
        except TransportError:
            return None

    def snapshot_dict(self) -> Optional[dict]:
        if not self.alive or self.state == GONE:
            return self._final_snapshot
        try:
            return self._rpc("snapshot")
        except TransportError:
            return self._final_snapshot

    def final_snapshot(self) -> Optional[dict]:
        return self._final_snapshot

    # --------------------------------------------------------- migration ---
    def export_chain(self, fp: int, max_depth: int = 64,
                     timeout: float = 60.0) -> Optional[dict]:
        """Pull a completed chain's KV pages out of this worker
        (prefill side of the migration protocol)."""
        return self._rpc("export_chain",
                         {"fp": int(fp), "max_depth": max_depth},
                         timeout=timeout)

    def adopt_chain(self, blob: dict, timeout: float = 60.0) -> dict:
        """Push an exported chain into this worker's pool/trie
        (decode side). The blob must be plain data (``check_plain``)."""
        check_plain(blob, "adopt_chain blob")
        return self._rpc("adopt_chain", {"blob": blob},
                         timeout=timeout)

    # chunked protocol (decode-overlapped transfer): one rpc per
    # bounded step — the worker's tick loop runs between steps, so
    # neither side stalls longer than one chunk's gather/scatter
    def export_chain_begin(self, fp: int, max_depth: int = 64,
                           timeout: float = 30.0) -> Optional[dict]:
        return self._rpc("export_chain_begin",
                         {"fp": int(fp), "max_depth": max_depth},
                         timeout=timeout)

    def export_chain_chunk(self, xid: int, start: int, count: int,
                           timeout: float = 30.0) -> dict:
        return self._rpc("export_chain_chunk",
                         {"xid": int(xid), "start": int(start),
                          "count": int(count)}, timeout=timeout)

    def export_chain_end(self, xid: int,
                         timeout: float = 30.0) -> None:
        self._rpc("export_chain_end", {"xid": int(xid)},
                  timeout=timeout)

    def adopt_chain_begin(self, header: dict,
                          timeout: float = 30.0) -> dict:
        return self._rpc("adopt_chain_begin", {"header": header},
                         timeout=timeout)

    def adopt_chain_chunk(self, aid: int, start: int, k, v,
                          timeout: float = 30.0) -> None:
        check_plain((k, v), "adopt_chain_chunk pages")
        self._rpc("adopt_chain_chunk",
                  {"aid": int(aid), "start": int(start),
                   "k": k, "v": v}, timeout=timeout)

    def adopt_chain_commit(self, aid: int,
                           timeout: float = 30.0) -> dict:
        return self._rpc("adopt_chain_commit", {"aid": int(aid)},
                         timeout=timeout)

    def adopt_chain_abort(self, aid: int,
                          timeout: float = 30.0) -> None:
        self._rpc("adopt_chain_abort", {"aid": int(aid)},
                  timeout=timeout)

    def flight_ticks(self, timeout: float = 30.0) -> List[dict]:
        """The worker's flight-recorder tick records (t_mono_s/dur_s);
        inter-tick gaps measure per-tick stall — how the
        decode-overlap claim is verified against the sync baseline."""
        return list(self._rpc("flight", timeout=timeout)["ticks"])
