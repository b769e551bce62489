"""Host and device tracing: ``paddle_tpu/profiler/__init__.py``.

The reference's ``Profiler`` with scheduler windows (``profiler.py:358``)
and its ``RecordEvent`` annotations, over ``torch.profiler``:

* ``RecordEvent(name)`` times its host span (``host_statistics``), hands
  it to the span sinks (``add_span_sink``; ``observability.
  bridge_record_events`` is one) and opens a
  ``torch.profiler.record_function`` range, where the JAX package opens a
  ``jax.profiler.TraceAnnotation``. ``end`` is idempotent. Inside a
  region that ``torch.compile`` captures it does nothing (its lock and
  clock read would break the graph).
* ``Profiler(scheduler=..., on_trace_ready=...)`` steps through
  ``make_scheduler``'s windows; over each RECORD window it runs
  ``torch.profiler.profile`` with the CPU activity and, when the card is
  there, the CUDA one (``targets`` narrows them; asking for the GPU
  without one raises). When a window closes its trace is ready:
  ``on_trace_ready(prof)`` runs, and ``export_chrome_tracing(dir)``'s
  handler writes the window's Chrome trace into ``dir``
  (``prof.trace_paths`` lists the files).
* torch records ``record_function`` ranges only on the thread that
  started the profiler, where ``jax.profiler`` records annotations from
  every thread. So while a window records, a ``RecordEvent`` closing on
  any other thread (the serving engine's tick thread) is kept by the
  profiler and written into the window's Chrome trace beside torch's own
  events: same ``cat`` ("user_annotation"), this process's pid, the
  thread's native id, on the trace's wall clock. The card's kernels are
  in the trace whichever thread launched them.
* Starting a window raises when another profiler is active (a second
  ``Profiler``, or a ``torch.profiler.profile`` of the caller's own); the
  JAX package's ``_start_trace`` swallows a failed start.
* ``timer_only=True`` times steps and spans and traces nothing.
"""
from __future__ import annotations

import contextlib
import enum
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Iterable, List, Optional

import torch
from torch.profiler import record_function

__all__ = ["ProfilerTarget", "ProfilerState", "make_scheduler",
           "export_chrome_tracing", "add_span_sink", "remove_span_sink",
           "RecordEvent", "host_statistics", "reset_host_statistics",
           "Profiler", "profile"]


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Reference make_scheduler: step -> state windows."""
    period = closed + ready + record

    def fn(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return fn


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` handler writing each window's Chrome trace
    to ``dir_name/<worker>.<window>.pt.trace.json`` (``worker_name``
    defaults to ``<host>_<pid>``)."""
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        worker = worker_name or f"{os.uname().nodename}_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{worker}.{len(prof.trace_paths)}.pt.trace.json")
        prof.export(path)
        prof.trace_paths.append(path)
    return handler


_stats_lock = threading.Lock()
_host_stats = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]

# span sinks: callables (name, t0_s, t1_s) invoked as each RecordEvent
# span closes, timestamps on time.monotonic(). The observability span
# tracer bridges through here (observability.bridge_record_events).
# Sink errors are swallowed: a broken exporter must not take down the
# annotated hot path.
_span_sinks = []

# the Profiler whose window is recording (at most one)
_recording: Optional["Profiler"] = None


def add_span_sink(fn) -> None:
    """Register ``fn(name, t0_s, t1_s)`` for every closing RecordEvent
    span (monotonic-clock seconds)."""
    _span_sinks.append(fn)


def remove_span_sink(fn) -> None:
    try:
        _span_sinks.remove(fn)
    except ValueError:
        pass


class RecordEvent:
    """User annotation span (reference: paddle.profiler.RecordEvent):
    times the host span and opens a ``torch.profiler.record_function``
    range (module docstring)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._rf = None
        self._t0 = None

    def begin(self):
        if torch.compiler.is_compiling():
            return
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        if self._rf is None:
            return
        dt = time.perf_counter() - self._t0
        # sample the endpoints NEXT to dt, before the locked stats update
        # and the range's teardown, so bridged spans are not translated
        # late under lock contention
        t1 = time.monotonic()
        wall1 = time.time_ns()
        with _stats_lock:
            st = _host_stats[self.name]
            st[0] += 1
            st[1] += dt
        self._rf.__exit__(None, None, None)
        self._rf = None
        prof = _recording
        if prof is not None:
            prof._foreign_span(self.name, wall1 - int(dt * 1e9), wall1)
        if _span_sinks:
            for fn in list(_span_sinks):
                try:
                    fn(self.name, t1 - dt, t1)
                except Exception:
                    pass

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def host_statistics():
    """name -> {calls, total_ms, avg_ms} for RecordEvent spans."""
    with _stats_lock:
        return {k: {"calls": v[0], "total_ms": v[1] * 1e3,
                    "avg_ms": v[1] * 1e3 / max(v[0], 1)}
                for k, v in _host_stats.items()}


def reset_host_statistics():
    with _stats_lock:
        _host_stats.clear()


def _activities(targets) -> List:
    from torch.profiler import ProfilerActivity
    if targets is None:
        return ([ProfilerActivity.CPU]
                + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                   else []))
    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            if not torch.cuda.is_available():
                raise RuntimeError("ProfilerTarget.GPU asked for, but CUDA "
                                   "is not available")
            acts.append(ProfilerActivity.CUDA)
        else:
            raise ValueError(f"the port profiles the CPU and the GPU, not "
                             f"{t}")
    return acts


class Profiler:
    """paddle.profiler.Profiler over ``torch.profiler`` (module
    docstring).

    with Profiler(scheduler=(2, 5)) as p:
        for batch in loader:
            step(batch)
            p.step()
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only: bool = False,
                 emit_nvtx: bool = False, with_flops: bool = False):
        if isinstance(scheduler, tuple):
            start, end = scheduler
            scheduler = make_scheduler(closed=start, ready=0,
                                       record=end - start, repeat=1)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._activities = None if timer_only else _activities(targets)
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._with_flops = with_flops
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._tracing = False
        self._prof = None        # the open torch profiler of a window
        self._last = None        # the last closed window's torch profiler
        self._foreign = []       # (name, t0_ns, t1_ns, tid) of the window
        self._last_foreign = []
        self._foreign_lock = threading.Lock()
        self._step_times = []
        self._last_step_t = None
        #: Chrome traces written by ``export_chrome_tracing``'s handler
        self.trace_paths: List[str] = []

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._last_step_t = time.perf_counter()
        self._transition()
        return self

    def stop(self):
        if self._tracing:
            self._stop_trace()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
        self._last_step_t = now
        self._step += 1
        self._transition()

    def _transition(self):
        state = (self._scheduler(self._step) if self._scheduler
                 else ProfilerState.RECORD)
        if self._timer_only:
            return
        should_trace = state in (ProfilerState.RECORD,
                                 ProfilerState.RECORD_AND_RETURN)
        if should_trace and not self._tracing:
            self._start_trace()
        elif not should_trace and self._tracing:
            self._stop_trace()
        self._state = state

    def _start_trace(self):
        global _recording
        if _recording is not None or getattr(
                torch.autograd.profiler, "_is_profiler_enabled", False):
            raise RuntimeError("a profiler is already active; one window "
                               "records at a time")
        prof = torch.profiler.profile(
            activities=self._activities, record_shapes=self._record_shapes,
            profile_memory=self._profile_memory, with_flops=self._with_flops)
        prof.__enter__()
        self._prof = prof
        with self._foreign_lock:
            self._foreign = []
        _recording = self
        self._tracing = True

    def _stop_trace(self):
        global _recording
        try:
            _recording = None
            self._prof.__exit__(None, None, None)
        finally:
            self._tracing = False
            self._last, self._prof = self._prof, None
            with self._foreign_lock:
                self._last_foreign, self._foreign = self._foreign, []
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def _foreign_span(self, name: str, t0_ns: int, t1_ns: int) -> None:
        if torch._C._autograd._profiler_enabled():
            return      # this thread's range is in torch's own events
        with self._foreign_lock:
            if _recording is self:
                self._foreign.append((name, t0_ns, t1_ns,
                                      threading.get_native_id()))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reports ------------------------------------------------------------
    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        lines = ["Profiler summary", "-" * 60]
        if self._step_times:
            ts = self._step_times
            lines.append(
                f"steps: {len(ts)}  avg {1e3 * sum(ts) / len(ts):.2f} ms  "
                f"min {1e3 * min(ts):.2f}  max {1e3 * max(ts):.2f}")
        for name, st in sorted(host_statistics().items(),
                               key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"{name:<40} x{st['calls']:<6} "
                         f"total {st['total_ms']:.2f} ms  "
                         f"avg {st['avg_ms']:.3f} ms")
        out = "\n".join(lines)
        print(out)
        return out

    def export(self, path: str, format: str = "json"):
        """Write the last closed window's Chrome trace to ``path``, the
        other threads' ``RecordEvent`` ranges merged in."""
        if format != "json":
            raise ValueError("the port writes Chrome traces (json) only")
        if self._last is None:
            raise RuntimeError("no profiler window has closed yet")
        self._last.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
        pid = os.getpid()
        trace["traceEvents"].extend(
            {"ph": "X", "cat": "user_annotation", "name": name, "pid": pid,
             "tid": tid, "ts": t0 / 1e3 - base_us, "dur": (t1 - t0) / 1e3,
             "args": {}}
            for name, t0, t1, tid in self._last_foreign)
        with open(path, "w") as f:
            json.dump(trace, f)


@contextlib.contextmanager
def profile(**kw):
    p = Profiler(**kw)
    p.start()
    try:
        yield p
    finally:
        p.stop()
