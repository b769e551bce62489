"""Span tracer: bounded-ring host spans with Perfetto export.

Port of ``paddle_tpu/observability/tracer.py``. Every serving tick,
engine phase and per-request lifecycle step records a *span* —
``(name, track, t0, t1, args)`` on the process-shared monotonic clock —
into a thread-safe bounded ring. ``export(path)`` writes the ring as
Chrome-trace JSON ("trace events" format), loadable in Perfetto or
chrome://tracing: one track per engine phase and one per serving slot.
For the same calls the JSON holds the same events, tracks and args as
the JAX package's; only the timestamps differ.

Design constraints, in order:

* **cheap when on** — a span append is one ``monotonic_ns`` pair, one
  small object and one deque append under a lock;
* **near-free when off** — ``enabled=False`` makes ``span()`` record
  nothing (no clock reads, no ring append); only the thread-local
  span-name push/pop survives, so the recompile sentinel's "load
  during <span>" attribution stays correct with tracing disabled;
* **never unbounded** — the ring is a ``deque(maxlen=capacity)``; old
  spans fall off and ``dropped`` counts them (the flight recorder's
  postmortem ships the recent window);
* **one clock** — ``time.monotonic()`` everywhere, the clock of the
  serving ``Request`` timestamps, so retroactive spans (queue wait,
  TTFT) are exactly the histogram observations.

The innermost open span of each thread is published module-wide
(``current_span()``): the recompile sentinel names each event after the
span it interrupted.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "SpanTracer", "current_span"]

_tls = threading.local()


def _span_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[str]:
    """Name of this thread's innermost OPEN span (None outside any).
    The recompile sentinel uses this to name what a compile event
    interrupted."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


class Span:
    """One closed span. Timestamps are ``time.monotonic()`` ns."""

    __slots__ = ("name", "track", "t0", "t1", "args", "tid")

    def __init__(self, name: str, track: str, t0: int, t1: int,
                 args: Optional[dict], tid: int):
        self.name = name
        self.track = track
        self.t0 = t0
        self.t1 = t1
        self.args = args
        self.tid = tid

    @property
    def dur_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def to_dict(self) -> dict:
        d = {"name": self.name, "track": self.track,
             "t0_s": self.t0 / 1e9, "dur_s": self.dur_s}
        if self.args:
            d["args"] = self.args
        return d


class _StackOnlyCtx:
    """Disabled-tracer span: maintains the thread-local span-name
    stack (so ``current_span()`` — the recompile sentinel's ``during``
    attribution — keeps working with tracing off) but records nothing:
    no clock reads, no Span allocation, no ring append."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        _span_stack().append(self._name)
        return self

    def __exit__(self, *exc):
        st = _span_stack()
        if st and st[-1] == self._name:
            st.pop()
        return False


class _SpanCtx:
    """Context manager recording one span on exit."""

    __slots__ = ("_tr", "_name", "_track", "_args", "_t0")

    def __init__(self, tr: "SpanTracer", name: str, track: str, args):
        self._tr = tr
        self._name = name
        self._track = track
        self._args = args

    def __enter__(self):
        _span_stack().append(self._name)
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        st = _span_stack()
        if st and st[-1] == self._name:
            st.pop()
        self._tr._append(Span(self._name, self._track, self._t0, t1,
                              self._args, threading.get_ident()))
        return False


class SpanTracer:
    """Thread-safe bounded ring of host spans.

        tr = SpanTracer()
        with tr.span("tick", track="engine.decode", tick=3):
            ...
        tr.add("queue", "slot0", t_submit, t_admit, req=12)  # retroactive
        tr.export("trace.json")       # Perfetto / chrome://tracing
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self._ring: "deque[Span]" = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.enabled = bool(enabled)
        self.dropped = 0
        self._t_open = time.monotonic_ns()

    # ------------------------------------------------------------ record ----
    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def span(self, name: str, track: Optional[str] = None, **args):
        """Timed context manager; ``track`` defaults to the name.
        Disabled tracers still publish the span name to
        ``current_span()`` (sentinel attribution) but record nothing."""
        if not self.enabled:
            return _StackOnlyCtx(name)
        return _SpanCtx(self, name, track or name, args or None)

    def add(self, name: str, track: str, t0_s: float, t1_s: float,
            **args) -> None:
        """Record a span from explicit ``time.monotonic()`` SECONDS
        timestamps (retroactive lifecycle spans: queue wait, TTFT,
        whole-request) — the same clock the serving Request stamps, so
        span durations equal the metric observations exactly."""
        if not self.enabled:
            return
        self._append(Span(name, track, int(t0_s * 1e9), int(t1_s * 1e9),
                          args or None, threading.get_ident()))

    def instant(self, name: str, track: str, **args) -> None:
        """Zero-length marker span (retire/evict/compile events)."""
        if not self.enabled:
            return
        t = time.monotonic_ns()
        self._append(Span(name, track, t, t, args or None,
                          threading.get_ident()))

    # ------------------------------------------------------------ export ----
    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first (consistent under
        concurrent appends)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def to_chrome_trace(self) -> dict:
        """The ring as a Chrome-trace ("trace events") dict: one
        Perfetto thread (tid) per distinct track, complete events
        ("ph": "X") with microsecond timestamps, a thread_name metadata
        event per track. Tracks sort engine phases first, then slots."""
        spans = self.spans()
        tracks: Dict[str, int] = {}
        for s in spans:
            if s.track not in tracks:
                tracks[s.track] = 0

        def _order(t: str):
            if t.startswith("engine"):
                return (0, 0, t)
            if t.startswith("slot") and t[4:].isdigit():
                return (2, int(t[4:]), t)   # slot10 after slot9
            return (1, 0, t)

        for i, t in enumerate(sorted(tracks, key=_order)):
            tracks[t] = i + 1
        events = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                   "args": {"name": "paddle_tpu serving"}}]
        for t, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": t}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": 1, "tid": tid,
                           "args": {"sort_index": tid}})
        for s in spans:
            ev = {"ph": "X", "name": s.name, "pid": 1,
                  "tid": tracks[s.track], "ts": s.t0 / 1e3,
                  "dur": max(s.t1 - s.t0, 0) / 1e3, "cat": s.track}
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"clock": "monotonic",
                              "spans": len(spans),
                              "dropped": self.dropped}}

    def export(self, path: str) -> str:
        """Write the ring as Perfetto-loadable Chrome-trace JSON;
        returns ``path``."""
        with open(path, "w") as f:
            # default=str: span args are plain host scalars by
            # convention, but an exotic arg must degrade to its repr,
            # not kill the export
            json.dump(self.to_chrome_trace(), f, default=str)
        return path
