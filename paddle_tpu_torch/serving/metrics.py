"""Serving-engine metrics: counters + histograms as plain dicts.

Copy of ``Histogram`` / ``ServingMetrics`` from
``paddle_tpu/serving/metrics.py`` (numpy only), with the counters and
histograms this engine records. ``snapshot()`` returns a plain dict.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict

import numpy as np

__all__ = ["Histogram", "ServingMetrics"]


class Histogram:
    """Windowed-reservoir histogram over the last ``cap`` observations:
    ``count``/``mean`` are lifetime; ``window_mean``/``p50``/``p99``/
    ``max`` cover only the window."""

    def __init__(self, cap: int = 65536):
        self._vals: "deque" = deque(maxlen=int(cap))
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self._count += 1
        self._sum += v
        self._vals.append(v)

    def summary(self) -> Dict[str, float]:
        if not self._vals:
            return {"count": 0, "mean": 0.0, "window_count": 0,
                    "window_mean": 0.0, "p50": 0.0, "p99": 0.0,
                    "max": 0.0}
        a = np.asarray(self._vals, np.float64)
        return {"count": self._count,
                "mean": self._sum / self._count,
                "window_count": int(a.size),
                "window_mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}


class ServingMetrics:
    """Counters + histograms for the continuous-batching engine.

    Counters: request lifecycle (submitted/admitted/completed/cancelled/
    timed_out/rejected), work units (ticks — engine ticks that ran the
    model, prefills, prefill_chunks, decode_steps — decode steps taken
    while streams were live, model_steps — forward passes of the whole
    model the engine ran, tokens_out) and prefix-cache effectiveness
    (prefix_hits / prefix_misses per admission, prefix_hit_tokens —
    prompt tokens not recomputed, prefix_pages_saved — pages attached
    instead of allocated).
    Histograms: queue_wait_s (submit -> admission), ttft_s (submit ->
    first token), decode_step_s (one engine tick per decode step),
    decode_stall_s (gap between consecutive decode ticks while streams
    are live), batch_occupancy, page_utilization and chunk_queue_depth
    (sampled per tick).
    """

    COUNTERS = ("submitted", "admitted", "completed", "cancelled",
                "timed_out", "rejected", "ticks", "prefills",
                "prefill_chunks", "decode_steps", "model_steps",
                "tokens_out", "prefix_hits", "prefix_misses",
                "prefix_hit_tokens", "prefix_pages_saved")
    HISTOGRAMS = ("queue_wait_s", "ttft_s", "decode_step_s",
                  "decode_stall_s", "batch_occupancy",
                  "page_utilization", "chunk_queue_depth")

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {k: 0 for k in self.COUNTERS}
        self.histograms = {k: Histogram() for k in self.HISTOGRAMS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            self.histograms[name].observe(v)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict export: {'counters': {...}, 'histograms': {name:
        {count, mean, window_count, window_mean, p50, p99, max}}}."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "histograms": {k: h.summary()
                                   for k, h in self.histograms.items()}}
