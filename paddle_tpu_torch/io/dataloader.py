"""DataLoader: ``paddle_tpu/io/dataloader.py`` on torch tensors.

Batches are collated on the host and land on ``places`` (the card unless
the caller names another device, ``device.resolve_device``): the
collated tree's tensors (and numpy arrays, made tensors) are copied
there from pinned memory with ``non_blocking=True``. ``pin_memory()``
takes a fresh block of torch's caching host allocator for each batch,
which keeps the block until the copy's stream has passed it, so no
staging buffer is reused while a copy may still read it.

Three iterators, as in the JAX package:

* ``num_workers=0``: the calling thread collates each batch;
* ``use_shared_memory=False``: ``num_workers`` threads collate batches
  in any order, and the parent yields them in order;
* otherwise ``num_workers`` processes forked from the caller (the
  dataset is not pickled) each collate every W-th batch (batch *i* on
  worker *i* mod W) and pass its tensors, moved to shared memory,
  through a ``torch.multiprocessing`` queue of its own
  (``prefetch_factor`` batches deep); the parent takes the queues in
  turn, which keeps the
  order. A worker's exception comes back as ``RuntimeError("DataLoader
  worker failed:\\n" + traceback)``; ``worker_init_fn`` and
  ``get_worker_info()`` work inside a worker. When iteration ends or
  breaks, the workers are told to stop and joined, or terminated after
  5 s. Nothing in a worker touches CUDA (the workers are forked from a
  process whose CUDA context may be live): pinning and the copy to the
  card happen in the parent.

The JAX package's workers pass numpy batches through its native
shared-memory ring and fall back to threads when that library does not
load; here torch's shared memory takes the ring's place, and there is
no fallback.

Collation (``default_collate_fn``) keeps numpy's dtypes: int64 labels
stay int64, f64 stays f64 (the JAX package's tensors canonicalise to
int32 / f32). An ``IterableDataset`` is batched in the calling thread.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn",
           "get_worker_info"]

_worker_info = threading.local()
_JOIN_S = 5.0


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def default_collate_fn(batch: List[Any]):
    """Stack samples into batch tensors (reference:
    python/paddle/io/dataloader/collate.py): tensors with ``torch.stack``,
    numpy arrays and numbers through ``np.stack`` / ``np.asarray``,
    strings as lists, dicts and sequences field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(items))
                            for items in zip(*batch))
    raise TypeError(f"cannot collate type {type(sample)}")


def _tree_to_tensor(obj):
    """numpy arrays of numbers in a collated tree, made tensors."""
    if isinstance(obj, np.ndarray) and obj.dtype.kind in "biufc":
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _tree_to_tensor(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_tensor(v) for v in obj)
    return obj


def _tree_to_device(obj, device: torch.device):
    if isinstance(obj, np.ndarray) and obj.dtype.kind in "biufc":
        obj = torch.from_numpy(obj)
    if isinstance(obj, torch.Tensor):
        if obj.device == device:
            return obj
        if device.type == "cuda" and obj.device.type == "cpu":
            return obj.pin_memory().to(device, non_blocking=True)
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _tree_to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_device(v, device) for v in obj)
    return obj


def _put(q, item, stop) -> bool:
    """Put ``item`` on a bounded queue unless the parent said stop."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None, batch_size=1,
                 shuffle: bool = False, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 use_buffer_reader: bool = True, prefetch_factor: int = 2,
                 use_shared_memory: bool = True, timeout: int = 0,
                 worker_init_fn: Optional[Callable] = None,
                 persistent_workers: bool = False):
        if isinstance(places, (list, tuple)):
            places = places[0]
        self.device = resolve_device(places)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, num_workers)
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = max(1, prefetch_factor)
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable:
            it = self._iter_iterable()
        elif self.num_workers == 0:
            it = self._iter_single()
        elif self.use_shared_memory:
            it = self._iter_multiprocess()
        else:
            it = self._iter_threaded()
        return self._on_device(it)

    def _on_device(self, it):
        try:
            for b in it:
                yield _tree_to_device(b, self.device)
        finally:
            it.close()   # a break stops the workers now, not at collection

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(batch)

    def _iter_single(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _iter_multiprocess(self):
        """Forked workers, one queue each (module docstring)."""
        import torch.multiprocessing as tmp
        batches = list(self.batch_sampler)
        W = min(self.num_workers, max(len(batches), 1))
        ctx = tmp.get_context("fork")
        queues = [ctx.Queue(maxsize=self.prefetch_factor) for _ in range(W)]
        stop = ctx.Event()

        def worker_main(wid):
            torch.set_num_threads(1)
            q = queues[wid]
            try:
                _worker_info.info = WorkerInfo(wid, W, self.dataset)
                if self.worker_init_fn:
                    self.worker_init_fn(wid)
                for i in range(wid, len(batches), W):
                    samples = [self.dataset[j] for j in batches[i]]
                    if not _put(q, ("batch", _tree_to_tensor(
                            self.collate_fn(samples))), stop):
                        break
            except Exception:
                _put(q, ("error", traceback.format_exc()), stop)
            # the batches' shared memory is handed over by this process
            # (torch passes the descriptors on request), so it stays up
            # until the parent is done with them
            stop.wait()
            q.cancel_join_thread()

        procs = [ctx.Process(target=worker_main, args=(w,), daemon=True)
                 for w in range(W)]
        for p in procs:
            p.start()
        try:
            for i in range(len(batches)):
                kind, payload = self._get(queues[i % W], procs[i % W])
                if kind == "error":
                    raise RuntimeError("DataLoader worker failed:\n"
                                       + payload)
                yield payload
        finally:
            stop.set()
            deadline = time.monotonic() + _JOIN_S
            for p in procs:
                p.join(timeout=max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join()
            for q in queues:
                q.cancel_join_thread()
                q.close()

    @staticmethod
    def _get(q, proc):
        """The next message of one worker's queue; raises if the worker
        died without sending it."""
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if not proc.is_alive():
                    raise RuntimeError(
                        f"DataLoader worker (pid {proc.pid}) exited with "
                        f"code {proc.exitcode} before sending its batch")

    def _iter_threaded(self):
        """Prefetching pipeline: worker threads collate; a bounded queue
        gives ``prefetch_factor * num_workers`` batches in flight."""
        out_q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch_factor * self.num_workers)
        idx_q: "queue.Queue" = queue.Queue()
        n_batches = 0
        for i, indices in enumerate(self.batch_sampler):
            idx_q.put((i, indices))
            n_batches += 1
        stop = threading.Event()

        def worker(wid):
            _worker_info.info = WorkerInfo(wid, self.num_workers, self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(wid)
            while not stop.is_set():
                try:
                    i, indices = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.collate_fn(
                        [self.dataset[j] for j in indices])
                    out_q.put((i, batch))
                except Exception as e:  # surface worker errors
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True,
                                    name=f"dataloader-{w}")
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            # reorder into sequential batch order
            pending = {}
            next_idx = 0
            received = 0
            while received < n_batches:
                i, batch = out_q.get()
                received += 1
                pending[i] = batch
                while next_idx in pending:
                    b = pending.pop(next_idx)
                    next_idx += 1
                    if isinstance(b, Exception):
                        raise b
                    yield b
        finally:
            stop.set()
