"""Flight recorder: last-N-ticks ring + crash postmortem dump.

Port of ``paddle_tpu/observability/flight.py``. When the serving engine
dies — a ``KVInvariantError`` from the per-tick paged-KV audit, or any
unhandled engine-loop exception — the aggregate histograms say nothing
about *which* geometry, kernel libraries and recent tick timeline
produced the failure. The flight recorder keeps a small ring of
per-tick records (tick index, duration, live slots, span tokens,
pool/queue gauges); ``dump()`` writes one JSON postmortem combining the
ring, the span tracer's recent window, the metrics snapshot, the state
the engine hands it (scheduler slots and rows, pool occupancy, prefix
cache stats) and the error, with the KV-invariant violation list when
that is what killed the engine. The document's keys and its schema
string are the JAX package's, so one reader reads both packages'
postmortems.

The engine calls ``record_tick`` under its tick lock (single writer);
``dump`` may run from the dying worker or from a caller thread, so the
ring is locked anyway. Everything stored is plain host data: recording
a tick is a dict build and a deque append, no device sync.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

__all__ = ["FlightRecorder", "default_flight_dir"]


def default_flight_dir() -> str:
    """Postmortem directory: ``PADDLE_TPU_FLIGHT_DIR`` env var, else
    ``<tmp>/paddle_tpu_flight``."""
    d = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
    if d:
        return d
    import tempfile
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_flight")


def _jsonable(x):
    """Best-effort plain-data coercion (numpy scalars and arrays, torch
    tensors, sets)."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return str(x)


class FlightRecorder:
    """Bounded ring of per-tick serving records + postmortem writer."""

    def __init__(self, capacity: int = 64):
        self._ticks: "deque[dict]" = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.capacity = int(capacity)

    def record_tick(self, **record) -> None:
        """Append one tick record (plain host data only)."""
        with self._lock:
            self._ticks.append(record)

    def ticks(self) -> List[dict]:
        with self._lock:
            return list(self._ticks)

    def dump(self, path: Optional[str] = None, *, error=None,
             dir: Optional[str] = None,
             geometry: Optional[str] = None,
             programs: Optional[dict] = None,
             state: Optional[dict] = None,
             spans: Optional[list] = None,
             metrics: Optional[dict] = None,
             sentinel: Optional[dict] = None) -> str:
        """Write one JSON postmortem; returns the path written.

        ``error`` may be any exception — a ``KVInvariantError``'s
        violation list and context are lifted into structured fields.
        ``path=None`` writes ``postmortem-<pid>-<monotonic_ns>.json``
        under ``dir`` (default :func:`default_flight_dir`), created if
        missing.
        """
        if path is None:
            d = dir or default_flight_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"postmortem-{os.getpid()}-{time.monotonic_ns()}.json")
        doc = {
            "schema": "paddle_tpu.flight_recorder/1",
            "written_unix_s": time.time(),
            "ticks": self.ticks(),
            "tick_ring_capacity": self.capacity,
        }
        if error is not None:
            err = {"type": type(error).__name__, "message": str(error)}
            violations = getattr(error, "violations", None)
            if violations is not None:
                err["violations"] = [
                    {"code": getattr(v, "code", ""),
                     "message": getattr(v, "message", str(v))}
                    for v in violations]
            ctx = getattr(error, "context", None)
            if ctx:
                err["context"] = str(ctx)
            doc["error"] = err
        if geometry is not None:
            doc["geometry"] = geometry
        if programs is not None:
            doc["expected_programs"] = _jsonable(programs)
        if state is not None:
            doc["state"] = _jsonable(state)
        if spans is not None:
            doc["spans"] = spans
        if metrics is not None:
            doc["metrics"] = _jsonable(metrics)
        if sentinel is not None:
            doc["sentinel"] = _jsonable(sentinel)
        with open(path, "w") as f:
            json.dump(_jsonable(doc), f)
        return path
