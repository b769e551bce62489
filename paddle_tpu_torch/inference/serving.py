"""Serving-side dynamic batching.

Port of ``paddle_tpu/inference/serving.py`` ``DynamicBatcher`` (:45),
copied, not imported. A single background worker coalesces concurrent
requests into the largest batch available within a latency budget, pads
the batch dim to a bucket (bounding the shapes a captured program sees),
runs ``fn`` once, and scatters the rows back to their callers' futures.

    pred = DynamicBatcher(lambda x: predictor(x)[0],
                          max_batch_size=8, max_delay_ms=4)
    y = pred.infer(x_row)          # blocking; batched under the hood
    fut = pred.submit(x_row)       # async; fut.result()

Requests are grouped by their trailing (per-example) shape/dtype:
mixed-shape traffic never lands in one batch. ``stats`` exposes
request/batch counts for monitoring the coalescing ratio. ``fn`` may
return numpy arrays or torch tensors (on any device); callers get numpy
rows, a bfloat16 tensor widened exactly to float32 (numpy has no
bfloat16).
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["DynamicBatcher"]


def _numpy(o) -> np.ndarray:
    if isinstance(o, torch.Tensor):
        o = o.detach()
        if o.dtype == torch.bfloat16:
            o = o.float()
        return o.cpu().numpy()
    return np.asarray(o)


class _Request:
    __slots__ = ("arr", "future", "key", "length")

    def __init__(self, arr, key, length=None):
        self.arr = arr
        self.key = key
        self.length = length
        self.future: Future = Future()


class DynamicBatcher:
    """Coalesce single-example requests into padded batches.

    fn: callable mapping a batched array ``[B, ...]`` to either one
    array ``[B, ...]`` or a tuple/list of arrays each with leading B.
    max_batch_size: largest batch handed to ``fn``.
    max_delay_ms: how long the worker waits for more same-shape
      requests after the first one arrives (the latency/throughput
      knob; 0 = never wait).
    batch_buckets: batch sizes the batch dim is padded UP to (bounds
      the number of shapes ``fn`` sees); default powers of two up to
      max_batch_size.
    seq_buckets: RAGGED mode for 1-D token-id requests (paged decode —
      reference: the serving layer over block_multihead_attention).
      Each request is right-padded to the smallest bucket >= its
      length, so MIXED-length requests share one batch; ``fn`` is then
      called as ``fn(batch [B, Tb], lengths [B])`` and its per-row
      output is sliced back to each caller. Pairs with
      ``GenerationPredictor.generate_ragged`` / ``generate_paged``:
      short requests stop paying long requests' max-length padding.
    """

    def __init__(self, fn: Callable, max_batch_size: int = 8,
                 max_delay_ms: float = 4.0,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self._fn = fn
        self._seq_buckets = (sorted(int(b) for b in seq_buckets)
                             if seq_buckets else None)
        self._max_b = int(max_batch_size)
        self._delay = max(float(max_delay_ms), 0.0) / 1e3
        if batch_buckets is None:
            batch_buckets = []
            b = 1
            while b < self._max_b:
                batch_buckets.append(b)
                b *= 2
            batch_buckets.append(self._max_b)
        self._buckets = sorted(set(int(b) for b in batch_buckets))
        if self._buckets[-1] != self._max_b:
            raise ValueError("batch_buckets must include max_batch_size")
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # mismatched-shape requests popped mid-coalesce wait here and
        # SEED the next batch — requeueing to the FIFO's back would let
        # sustained same-shape traffic starve them forever
        self._stash: "deque[_Request]" = deque()
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0}
        self._closed = False
        self._lock = threading.Lock()  # orders submit() vs close()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="inference-serving")
        self._worker.start()

    # ------------------------------------------------------------- API ----
    def submit(self, x) -> Future:
        """Queue one example (NO leading batch dim); returns a Future of
        its result row (same structure ``fn`` returns, minus batch)."""
        arr = np.asarray(x)
        if self._seq_buckets is not None:
            if arr.ndim != 1:
                raise ValueError(
                    "seq_buckets mode takes 1-D token-id requests, got "
                    f"shape {arr.shape}")
            n = arr.shape[0]
            bucket = next((b for b in self._seq_buckets if n <= b), None)
            if bucket is None:
                raise ValueError(
                    f"request length {n} exceeds the largest seq bucket "
                    f"{self._seq_buckets[-1]}")
            padded = np.zeros((bucket,), arr.dtype)
            padded[:n] = arr
            req = _Request(padded, ((bucket,), str(arr.dtype)), length=n)
        else:
            req = _Request(arr, (arr.shape, str(arr.dtype)))
        with self._lock:
            # under the lock, a request either precedes the close
            # sentinel in the queue (and is drained) or raises — it can
            # never land behind the sentinel and hang its caller
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put(req)
        return req.future

    def infer(self, x):
        return self.submit(x).result()

    def close(self):
        """Drain and stop the worker (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- worker ----
    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _loop(self):
        import time
        stopping = False
        while not stopping:
            if self._stash:
                req = self._stash.popleft()  # stashed requests go FIRST
            else:
                req = self._q.get()
                if req is None:
                    break
            batch = [req]
            # same-shape companions already waiting in the stash
            for r in list(self._stash):
                if len(batch) >= self._max_b:
                    break
                if r.key == req.key:
                    self._stash.remove(r)
                    batch.append(r)
            deadline = time.monotonic() + self._delay
            # coalesce same-shape requests until full or the budget ends
            while len(batch) < self._max_b:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    stopping = True  # run this batch, then drain below
                    break
                if nxt.key == req.key:
                    batch.append(nxt)
                else:
                    self._stash.append(nxt)  # seeds the NEXT batch
            self._run(batch)
        # drain anything left after close() — every accepted request
        # resolves (submit() orders itself before the sentinel)
        leftovers = list(self._stash)
        self._stash.clear()
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        for r in leftovers:
            self._run([r])

    def _run(self, batch):
        n = len(batch)
        b = self._bucket(n)
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_rows"] += b - n
        stacked = np.stack([r.arr for r in batch])
        if b > n:
            pad = np.zeros((b - n,) + stacked.shape[1:], stacked.dtype)
            stacked = np.concatenate([stacked, pad])
        try:
            if self._seq_buckets is not None:
                lengths = np.asarray([r.length for r in batch] +
                                     [1] * (b - n), np.int32)
                out = self._fn(stacked, lengths)
            else:
                out = self._fn(stacked)
        except Exception as e:  # propagate to every caller in the batch
            for r in batch:
                r.future.set_exception(e)
            return
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        outs = [_numpy(o) for o in outs]
        for i, r in enumerate(batch):
            row = tuple(o[i] for o in outs) if multi else outs[0][i]
            r.future.set_result(row)
