"""Replica: one ``ServingEngine`` under a fleet lifecycle state machine.

Port of ``paddle_tpu/serving/fleet/replica.py``. A :class:`Replica` is
the fleet's unit of membership: it owns exactly one engine, advertises a
health view fed from the engine's live gauges (``gauges()``, the flight
recorder, the recompile sentinel), and implements the drain protocol the
router depends on.

Lifecycle::

    JOINING ──start()──> SERVING ──drain()──> DRAINING ──> GONE

* **JOINING** — constructed, engine not yet built or warmed. The router
  never routes here.
* **SERVING** — engine up, admission open. The only state the router
  selects.
* **DRAINING** — admission stopped; in-flight slots (decoding or parked
  mid chunked-prefill) run to completion. Entered by ``drain()`` and
  left when the engine's hand-back close returns.
* **GONE** — engine closed; the replica remains only for postmortem
  views (its flight-recorder window and final metrics snapshot).

The drain protocol (drain-on-failure included): ``drain()`` flips the
state so the router stops selecting the replica, then calls
``engine.close(drain=True, hand_back=True)`` — the engine stops
admission, finishes every in-flight slot, and returns the
queued-but-unadmitted requests STILL QUEUED, which ``drain()`` hands to
the caller (the fleet re-dispatches them through the router, exactly
once per request id). The same ``Request`` object moves, so the caller's
handle resolves wherever it lands.

Replicas are threads here (each engine owns a worker thread, and the
engines of one card share the params and the default stream), but the
API is process-shaped: health dicts, Prometheus text, fingerprint
summaries and handed-back request lists are plain data.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..locktrace import wrap_lock

__all__ = ["Replica", "JOINING", "SERVING", "DRAINING", "GONE",
           "ROLE_GENERAL", "ROLE_PREFILL", "ROLE_DECODE"]

JOINING = "joining"
SERVING = "serving"
DRAINING = "draining"
GONE = "gone"

# Role tags for prefill/decode disaggregation. Chunked prefill's
# park/stash discipline means a prefill-heavy engine is the SAME
# engine — the split is purely a routing policy (router.py classifies
# each request by its prompt/decode balance and prefers the matching
# pool), so roles are labels on replicas, not engine variants.
ROLE_GENERAL = "general"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

_ROLES = (ROLE_GENERAL, ROLE_PREFILL, ROLE_DECODE)


class Replica:
    """One engine + lifecycle + health view (see module docstring).

    ``engine_factory`` is a zero-arg callable returning a fresh
    ``ServingEngine`` — construction is deferred to :meth:`start` so a
    fleet can stage membership (bump its generation, announce the
    join) before paying engine bring-up.
    """

    _CC_LOCK_FREE_READS = {
        "engine": "health-view snapshot pattern: accessors bind eng = "
                  "self.engine once and tolerate staleness; close() "
                  "races degrade to a refusal or an empty view, never "
                  "a torn read",
        "state": "single opaque string replaced atomically under "
                 "_lock; health/load readers accept one stale "
                 "transition by design (the router re-polls)",
    }

    def __init__(self, name: str, engine_factory: Callable, *,
                 role: str = ROLE_GENERAL, generation: int = 0):
        if role not in _ROLES:
            raise ValueError(f"role must be one of {_ROLES}, "
                             f"got {role!r}")
        self.name = str(name)
        self.role = role
        self.generation = int(generation)   # fleet generation at join
        self._factory = engine_factory
        self._lock = wrap_lock(threading.RLock(), "Replica._lock")
        self.state = JOINING
        self.engine = None
        self.joined_t = time.monotonic()
        # final snapshot/sentinel/flight window captured at close time:
        # GONE replicas answer health()/sentinel_report()/flight_ticks()
        # from these, and the ENGINE ITSELF is dropped — a drained
        # replica must not pin a whole KV page pool for the life of an
        # elastic fleet
        self._final_snapshot: Optional[dict] = None
        self._final_sentinel: Optional[dict] = None
        self._final_flight: list = []
        self._final_postmortem: Optional[str] = None

    def __repr__(self):
        return (f"Replica({self.name!r}, role={self.role}, "
                f"state={self.state})")

    # -------------------------------------------------------- lifecycle ----
    def start(self, warm: bool = True) -> "Replica":
        """Build the engine and enter SERVING. ``warm=True`` runs the
        engine's ``warm_programs`` before admitting traffic: every
        kernel library of its inventory is loaded (once a process, so
        only the fleet's FIRST replica pays the loads and later joins
        are sentinel-clean by construction)."""
        with self._lock:
            if self.state != JOINING:
                raise RuntimeError(
                    f"replica {self.name} cannot start from state "
                    f"{self.state}")
            self.engine = self._factory()
            if warm:
                self.engine.warm_programs()
            self.state = SERVING
        return self

    def drain(self) -> List:
        """The drain protocol: stop admission, finish in-flight slots,
        return the queued-but-unadmitted requests (still QUEUED — the
        fleet re-dispatches them). Idempotent: a second drain returns
        ``[]``. Also the drain-ON-FAILURE path: when the engine worker
        has died, the engine already failed its requests (nothing left
        to hand back), so this just reaps the engine and reports
        GONE."""
        return self.close(drain=True, hand_back=True)

    def close(self, drain: bool = True,
              hand_back: bool = False) -> List:
        """EVERY shutdown goes through here — drain (hand-back), fleet
        close (full drain: with no survivors the queue must be served,
        not handed back), or cancel-close — so the state machine,
        idempotence guard and the final snapshot/sentinel capture
        (what GONE replicas answer ``health()``/``sentinel_report()``
        from) hold whatever the shutdown path."""
        with self._lock:
            if self.state in (DRAINING, GONE):
                return []
            self.state = DRAINING
            eng = self.engine
        handed: List = []
        if eng is not None:
            # live worker: admission stops; hand_back returns the
            # queue, plain drain serves it, drain=False cancels it.
            # Dead worker: close() just reaps the sentinel and returns
            # whatever was already handed back.
            handed = eng.close(drain=drain, hand_back=hand_back)
            try:
                # AFTER the close: the final snapshot must include the
                # requests that completed during the drain itself
                self._final_snapshot = eng.snapshot()
            except Exception:
                self._final_snapshot = None
            if eng.sentinel is not None:
                self._final_sentinel = eng.sentinel.report()
            try:
                self._final_flight = eng.flight.ticks()
            except Exception:
                self._final_flight = []
            self._final_postmortem = eng.postmortem_path
        with self._lock:
            self.state = GONE
            # drop the engine: everything a postmortem needs was just
            # captured, and a GONE replica must not pin a KV page pool
            # per membership change
            self.engine = None
        return handed

    # ----------------------------------------------------------- health ----
    # NOTE on concurrency: ``self.engine`` is nulled by close() while
    # router threads may be mid-read — every accessor snapshots it
    # into a local ONCE and tolerates the handle going stale (a closed
    # engine refuses injections and reads safely), so a concurrent
    # drain degrades to a refusal/empty answer, never an
    # AttributeError escaping into submit()/redispatch().
    @staticmethod
    def _eng_alive(eng) -> bool:
        return bool(eng is not None and eng.alive)

    @property
    def alive(self) -> bool:
        """Engine constructed, worker thread running, no recorded
        death."""
        return self._eng_alive(self.engine)

    @property
    def serving(self) -> bool:
        """True iff the router may select this replica."""
        return self.state == SERVING and self.alive

    def health(self) -> dict:
        """Plain-dict health view: lifecycle + liveness + the engine's
        live gauges (queue depth, occupancy, free pages, prefix-cache
        stats — the same numbers ``expose()`` publishes, so the
        router's load signal and the scrape endpoint can never
        disagree). GONE replicas report their drain-time snapshot's
        gauges."""
        eng = self.engine
        h = {"name": self.name, "role": self.role, "state": self.state,
             "generation": self.generation,
             "alive": self._eng_alive(eng)}
        if self.state == GONE or eng is None:
            if self._final_snapshot is not None:
                h["gauges"] = {
                    k: v for k, v in
                    self._final_snapshot.get("gauges", {}).items()
                    if isinstance(v, (int, float))}
            return h
        if h["alive"]:
            try:
                h["gauges"] = eng.gauges()
            except Exception:
                h["alive"] = False
        return h

    def load(self) -> float:
        """Scalar routing load: queued requests + occupied slots
        (queue depth dominates — an engine with a deep queue is
        behind however empty its batch is). ``inf`` when not
        servable, so any max/min comparison naturally excludes it."""
        eng = self.engine
        if self.state != SERVING or not self._eng_alive(eng):
            return float("inf")
        try:
            g = eng.gauges()
            max_batch = eng.scheduler.max_batch
        except Exception:
            return float("inf")
        return float(g.get("queued", 0)
                     + g.get("occupancy", 0.0) * max_batch)

    def affinity_summary(self, max_depth: int = 2) -> dict:
        """The engine's prefix-cache hot-chain fingerprints (``{}``
        when not serving or the cache is off)."""
        eng = self.engine
        if self.state != SERVING or not self._eng_alive(eng):
            return {}
        try:
            return eng.affinity_summary(max_depth)
        except Exception:
            return {}

    def sentinel_report(self) -> Optional[dict]:
        """Recompile-sentinel report (live engine or the one captured
        at drain); None when the sentinel is disabled."""
        if self._final_sentinel is not None:
            return self._final_sentinel
        eng = self.engine
        if eng is not None and eng.sentinel is not None:
            return eng.sentinel.report()
        return None

    def flight_ticks(self) -> list:
        """Flight-recorder tick records: the live engine's window, or
        the one captured at close for GONE replicas."""
        eng = self.engine
        if eng is not None:
            return eng.flight.ticks()
        return list(self._final_flight)

    def final_snapshot(self) -> Optional[dict]:
        """Metrics snapshot captured when the replica closed (None
        while the engine is live — read ``engine.snapshot()`` then)."""
        return self._final_snapshot

    @property
    def postmortem_path(self) -> Optional[str]:
        eng = self.engine
        return eng.postmortem_path if eng is not None \
            else self._final_postmortem

    # --------------------------------------------------------- admission ----
    def inject(self, req) -> bool:
        """Offer a request to this replica (router dispatch path);
        False when not serving or the engine refuses it. Races with a
        concurrent drain resolve to False (a closing engine refuses
        injections), never to an exception."""
        eng = self.engine
        if self.state != SERVING or eng is None:
            return False
        return eng.inject(req)
