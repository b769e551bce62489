"""Runtime lock tracing and seeded schedule perturbation.

Port of ``paddle_tpu/serving/locktrace.py`` (the port's own copy; it is
stdlib-only and imports nothing of the port either):

* :class:`TracedLock` wraps a ``threading.Lock``/``RLock`` and records,
  per thread, which locks are held while which are acquired. Every
  (held -> acquired) pair is an edge of the runtime acquisition graph;
  an edge observed in BOTH directions is a lock-order inversion (two
  threads can deadlock on those two locks) and is flagged the moment
  the second direction appears, no deadlock needed. Wait and hold times
  are aggregated per lock role.
* :func:`wrap_lock` is the construction-site hook every serving lock
  goes through (``self._lock = wrap_lock(threading.Lock(),
  "Class._lock")``). While tracing was never enabled it returns the raw
  lock: nothing is added to the tick path. Enable tracing BEFORE
  constructing engines and fleets (``PADDLE_TPU_SERVING_LOCK_TRACE=1``
  or :func:`enable`).
* :func:`host_sync` marks the engine's device-to-host read-backs and
  records which locks the pulling thread held: the per-tick token
  read-back under the tick lock is the design, and the count is pinned
  so that a new lock-held-across-sync shows.
* :class:`ScheduleFuzzer` and :func:`fuzz_point`: with a fuzzer
  installed, every traced acquire and every ``fuzz_point()`` site may
  sleep a few hundred microseconds, chosen by a seeded RNG, so a
  protocol (drain and hand-back, the migration handoff, a crash
  mid-stream) replayed under many seeds meets interleavings the example
  tests never hit, reproducibly by seed.

Lock NAMES are roles (``"ServingEngine._tick_lock"``), not instances:
the N engines of a fleet share one role per lock, and the ordering
discipline under test is between roles. The names are the JAX
package's, so ``LockTracer.report()`` reads the same in both.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LockTracer", "TracedLock", "ScheduleFuzzer", "wrap_lock",
           "enable", "disable", "get_tracer", "get_fuzzer",
           "fuzz_point", "host_sync", "ENV_FLAG"]

ENV_FLAG = "PADDLE_TPU_SERVING_LOCK_TRACE"


class LockTracer:
    """Records per-thread lock acquisition order + wait/hold times.

    Thread-safe; one instance is installed globally via
    :func:`enable`. The tracer's own mutex is leaf-only (never held
    while taking a traced lock), so tracing cannot introduce the
    ordering bugs it looks for.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_role, acquired_role) -> count
        self._edges: Dict[Tuple[str, str], int] = {}
        self._inversions: List[dict] = []
        # role -> [count, total_s, max_s]
        self._wait: Dict[str, List[float]] = {}
        self._hold: Dict[str, List[float]] = {}
        # "tag|held,held" -> count of host syncs with locks held
        self._sync_held: Dict[str, int] = {}

    # ------------------------------------------------------------ events ----
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def on_acquire(self, name: str, wait_s: float) -> Optional[dict]:
        """Record one successful acquire; returns the inversion record
        when this acquire completed a two-direction edge pair."""
        stack = self._stack()
        held = [n for n, _ in stack]
        inv = None
        with self._mu:
            w = self._wait.setdefault(name, [0, 0.0, 0.0])
            w[0] += 1
            w[1] += wait_s
            w[2] = max(w[2], wait_s)
            for h in held:
                if h == name:       # RLock re-entry is not an edge
                    continue
                edge = (h, name)
                fresh = edge not in self._edges
                self._edges[edge] = self._edges.get(edge, 0) + 1
                if fresh and (name, h) in self._edges:
                    inv = {"held": h, "acquiring": name,
                           "thread": threading.current_thread().name}
                    self._inversions.append(inv)
        stack.append((name, time.monotonic()))
        return inv

    def on_release(self, name: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0 = stack.pop(i)
                held_s = time.monotonic() - t0
                with self._mu:
                    h = self._hold.setdefault(name, [0, 0.0, 0.0])
                    h[0] += 1
                    h[1] += held_s
                    h[2] = max(h[2], held_s)
                return

    def on_host_sync(self, tag: str) -> None:
        held = [n for n, _ in self._stack()]
        if not held:
            return
        key = f"{tag}|{','.join(sorted(set(held)))}"
        with self._mu:
            self._sync_held[key] = self._sync_held.get(key, 0) + 1

    # ------------------------------------------------------------- views ----
    @property
    def inversions(self) -> List[dict]:
        with self._mu:
            return list(self._inversions)

    def edges(self) -> List[Tuple[str, str, int]]:
        with self._mu:
            return sorted((a, b, n)
                          for (a, b), n in self._edges.items())

    def report(self) -> dict:
        """Plain-dict summary: the runtime acquisition graph, observed
        inversions, wait/hold aggregates and locks-held-at-host-sync
        counts — the shape the flight-recorder postmortem and
        serving_bench embed."""
        with self._mu:
            fmt = lambda d: {k: {"n": int(v[0]),    # noqa: E731
                                 "total_s": round(v[1], 6),
                                 "max_s": round(v[2], 6)}
                             for k, v in sorted(d.items())}
            return {
                "edges": [[a, b, n] for (a, b), n
                          in sorted(self._edges.items())],
                "inversions": list(self._inversions),
                "wait_s": fmt(self._wait),
                "hold_s": fmt(self._hold),
                "host_sync_held": dict(sorted(self._sync_held.items())),
            }


class ScheduleFuzzer:
    """Seeded schedule perturbation: ``pause()`` sleeps/yields with
    probability ``p``, durations drawn from a seeded RNG — same seed,
    same decision sequence (interleavings still depend on the OS
    scheduler; the seed makes the PERTURBATION reproducible, which in
    practice reproduces failures within a few runs)."""

    def __init__(self, seed: int, p: float = 0.35,
                 max_sleep_s: float = 3e-4):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._mu = threading.Lock()
        self.p = float(p)
        self.max_sleep_s = float(max_sleep_s)
        self.points = 0

    def pause(self, tag: str) -> None:
        with self._mu:
            self.points += 1
            fire = self._rng.random() < self.p
            dt = self._rng.random() * self.max_sleep_s if fire else 0.0
        if fire:
            time.sleep(dt)      # sleep(0)..sleep(max): forces a GIL
            # drop even at 0-ish durations, so another runnable thread
            # gets the protocol's in-between state


class TracedLock:
    """Lock/RLock wrapper feeding the global tracer + fuzzer. Checks
    the globals at CALL time, so one wrapped lock stays valid across
    enable/disable cycles (tests flip tracing around a fleet's life)."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = str(name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        f = _STATE.fuzzer
        if f is not None:
            f.pause(f"lock:{self.name}")
        t = _STATE.tracer
        if t is None:
            return self._lock.acquire(blocking, timeout)
        t0 = time.monotonic()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            t.on_acquire(self.name, time.monotonic() - t0)
        return ok

    def release(self) -> None:
        self._lock.release()
        t = _STATE.tracer
        if t is not None:
            t.on_release(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"TracedLock({self.name!r})"


class _State:
    __slots__ = ("tracer", "fuzzer", "wrap_always")

    def __init__(self):
        self.tracer: Optional[LockTracer] = None
        self.fuzzer: Optional[ScheduleFuzzer] = None
        # once ANY enable happened, keep wrapping new locks so a
        # disable/enable cycle (test teardown/setup) still traces
        # engines built in between
        self.wrap_always = False


_STATE = _State()


def enable(fuzzer: Optional[ScheduleFuzzer] = None,
           tracer: Optional[LockTracer] = None) -> LockTracer:
    """Install a (fresh) tracer — and optionally a fuzzer — globally.
    Call BEFORE constructing the engines/fleets to trace: wrapping is
    decided at lock construction time."""
    _STATE.tracer = tracer if tracer is not None else LockTracer()
    _STATE.fuzzer = fuzzer
    _STATE.wrap_always = True
    return _STATE.tracer


def disable() -> Optional[LockTracer]:
    """Stop tracing/fuzzing; returns the outgoing tracer so callers
    can still pull its :meth:`LockTracer.report`."""
    t, _STATE.tracer, _STATE.fuzzer = _STATE.tracer, None, None
    return t


def get_tracer() -> Optional[LockTracer]:
    return _STATE.tracer


def get_fuzzer() -> Optional[ScheduleFuzzer]:
    return _STATE.fuzzer


def wrap_lock(lock, name: str):
    """Construction-site hook for every serving lock. Passthrough
    (returns ``lock`` unchanged) unless tracing/fuzzing is or has been
    enabled — the disabled tick path pays nothing."""
    if _STATE.tracer is None and _STATE.fuzzer is None \
            and not _STATE.wrap_always:
        return lock
    return TracedLock(lock, name)


def fuzz_point(tag: str) -> None:
    """Explicit perturbation site inside a protocol (between a
    decision and its commit). No-op unless a fuzzer is installed."""
    f = _STATE.fuzzer
    if f is not None:
        f.pause(tag)


def host_sync(tag: str) -> None:
    """Mark a sanctioned device->host sync site; records which locks
    the calling thread holds. No-op unless tracing is enabled."""
    t = _STATE.tracer
    if t is not None:
        t.on_host_sync(tag)


if os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "yes",
                                                    "on"):
    enable()
