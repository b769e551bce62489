"""Live recompile sentinel: a kernel library loaded mid-serving as an
alarm.

Port of ``paddle_tpu/observability/sentinel.py``, with one divergence in
what it watches. The JAX sentinel listens to ``jax.monitoring``'s XLA
compile events: every executable materialization in the process. The
port compiles nothing per shape — its ops run eagerly, with no
``torch.compile`` and no CUDA graphs — and its one runtime compile is
``ops/kernels/_build.load``, which builds a kernel library with ``nvcc``
(or ``dlopen``\\ s a built one) on its first use in the process. So the
port's event source is that: ``_build.load`` reports the seconds of each
first load as a ``COMPILE_EVENT`` through this module's stdlib-only
listener registry (:func:`record_event_duration_secs`, the counterpart
of ``jax.monitoring``), and one module-level listener dispatches it to
every live sentinel:

* before ``arm()`` (warmup), loads are counted but expected;
* after ``arm()``, every load is an alarm: a labeled WARN metric
  (``recompiles{during=...}``), a span on the ``sentinel`` track named
  after the innermost open span it interrupted ("compile during
  serving.tick"), and a ``RecompileWarning``.

When the port gains CUDA graphs, their captures become a second source
of the same event.

``report()`` carries the engine's *expected* inventory — for the port,
the kernel libraries its model and quantization reach
(``ServingEngine.program_inventory``) — with the JAX report's keys.
"""
from __future__ import annotations

import threading
import time
import warnings
import weakref
from collections import deque
from typing import Callable, List, Optional

from .tracer import current_span

__all__ = ["RecompileSentinel", "RecompileWarning", "COMPILE_EVENT",
           "RECOMPILES_METRIC", "register_event_duration_secs_listener",
           "record_event_duration_secs"]

# the event ``_build.load`` records for each first load of a kernel
# library in the process (an nvcc build included when the library was
# not built yet)
COMPILE_EVENT = "/paddle_tpu_torch/kernels/library_load_duration"
# the Prometheus series the sentinel's alarms land in
# (ServingMetrics.expose: <prefix>_<counter>_total)
RECOMPILES_METRIC = "paddle_serving_recompiles_total"


class RecompileWarning(UserWarning):
    """A post-warmup kernel library load was observed by a
    RecompileSentinel."""


# the event registry: fn(event, duration_s, **kw), called on the thread
# that recorded the event
_listeners: List[Callable] = []
_listeners_lock = threading.Lock()


def register_event_duration_secs_listener(fn: Callable) -> None:
    """Call ``fn(event, duration_s, **kw)`` on every recorded event."""
    with _listeners_lock:
        _listeners.append(fn)


def record_event_duration_secs(event: str, duration: float, **kw) -> None:
    """Record one timed event (``_build.load`` records ``COMPILE_EVENT``
    with ``library=<name>``): every listener sees it, on this thread."""
    with _listeners_lock:
        fns = list(_listeners)
    for fn in fns:
        fn(event, duration, **kw)


_installed = False
_install_lock = threading.Lock()
# live sentinels; weak so an abandoned engine cannot leak through the
# process-wide listener
_active: "weakref.WeakSet" = weakref.WeakSet()


def _on_event_duration(event: str, duration: float, **kw) -> None:
    if event != COMPILE_EVENT:
        return
    for s in list(_active):
        s._on_compile(duration, kw.get("library"))


def _install_listener() -> None:
    global _installed
    with _install_lock:
        if _installed:
            return
        register_event_duration_secs_listener(_on_event_duration)
        _installed = True


class RecompileSentinel:
    """Count and name every kernel library load; alarm on any after
    ``arm()``.

        s = RecompileSentinel(expected=eng.program_inventory,
                              tracer=tr, metrics=m, label="serving")
        ... warmup (ServingEngine.warm_programs) ...
        s.arm()                      # warmup done: loads now WARN
        ... serve ...
        s.report()["post_warmup_compiles"]   # 0 when clean

    The event fires on whichever thread first launched the kernel, so it
    is named after that thread's innermost open tracer span — for the
    serving engine, the tick span that stalled. ``close()`` detaches the
    sentinel (the process-wide listener stays, dispatching to whoever
    remains).

    Scope note: loads are PROCESS-wide, and each library loads once a
    process. A sentinel on a serving process attributes every
    post-warmup load to serving; co-resident work shows up too and is
    told apart by its ``during`` span name.
    """

    def __init__(self, *, expected=None, tracer=None, metrics=None,
                 label: str = "serving", max_events: int = 256):
        self.expected = expected
        self.label = label
        self._tracer = tracer
        self._metrics = metrics
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self.warmup_compiles = 0
        self.post_warmup_compiles = 0
        self.events: "deque[dict]" = deque(maxlen=int(max_events))
        self._closed = False
        _install_listener()
        _active.add(self)

    # ------------------------------------------------------------ state ----
    @property
    def armed(self) -> bool:
        return self._armed_at is not None

    @property
    def clean(self) -> bool:
        """True when no load has been seen since ``arm()``."""
        return self.post_warmup_compiles == 0

    def arm(self) -> None:
        """Declare warmup complete: every later load is an alarm.
        Idempotent (re-arming does not forgive earlier alarms)."""
        with self._lock:
            if self._armed_at is None:
                self._armed_at = time.monotonic()

    def close(self) -> None:
        """Stop observing (engine shutdown)."""
        self._closed = True
        _active.discard(self)

    # --------------------------------------------------------- listener ----
    def _on_compile(self, duration: float,
                    library: Optional[str] = None) -> None:
        if self._closed:
            return
        during = current_span()
        now = time.monotonic()
        with self._lock:
            armed = self._armed_at is not None
            ev = {"t_s": now, "compile_s": float(duration),
                  "during": during,
                  "phase": "post_warmup" if armed else "warmup",
                  "library": library}
            self.events.append(ev)
            if not armed:
                self.warmup_compiles += 1
                return
            self.post_warmup_compiles += 1
        name = f"compile during {during}" if during else \
            "compile (no active span)"
        if self._metrics is not None:
            try:
                self._metrics.inc("recompiles")
                self._metrics.inc_labeled(
                    "recompiles", during=during or "idle")
            except Exception:
                pass
        if self._tracer is not None:
            self._tracer.add(name, "sentinel", now - duration, now,
                             compile_s=round(float(duration), 6),
                             library=library)
        warnings.warn(
            f"[{self.label}] post-warmup kernel library load "
            f"{library!r} ({duration * 1e3:.1f} ms) — {name}; "
            f"warm_programs() did not cover this library",
            RecompileWarning, stacklevel=2)

    # ------------------------------------------------------------ export ----
    def report(self) -> dict:
        """Plain-dict sentinel state: counts, recent events, the
        expected kernel libraries, and ``clean``."""
        with self._lock:
            return {
                "label": self.label,
                "armed": self._armed_at is not None,
                "warmup_compiles": self.warmup_compiles,
                "post_warmup_compiles": self.post_warmup_compiles,
                "clean": self.post_warmup_compiles == 0,
                "expected_programs": self.expected,
                "events": list(self.events),
            }
