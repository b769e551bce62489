"""Continuous-batching scheduler: admission queue + slot/page budgets.

Copy of ``paddle_tpu/serving/scheduler.py`` (numpy and ``threading``
only). The decode batch is a FIXED array of ``max_batch`` slots, pages
come from the ``PagePool`` free list, and admission is page-budget
aware: a request is admitted only when a slot AND every page its full
generation can touch (prompt + max_new_tokens, minus any prefix-cached
pages it attaches) are available, so a running sequence never hits pool
exhaustion mid-flight. The queue is strict FIFO by default;
``admission_window=N`` lets up to N requests behind a non-fitting head
be admitted first.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ..inference.paged_kv import PagePool

__all__ = ["Request", "RequestHandle", "Scheduler",
           "QUEUED", "RUNNING", "COMPLETED", "CANCELLED", "TIMED_OUT",
           "REJECTED"]

QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"
CANCELLED = "cancelled"
TIMED_OUT = "timed_out"
REJECTED = "rejected"

_END = object()  # stream sentinel
_ids = itertools.count()


class Request:
    """One generation request's full lifecycle state (engine-internal;
    callers hold the RequestHandle)."""

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_token_id",
                 "deadline_s", "state", "tokens",
                 "submit_t", "admit_t", "first_token_t", "finish_t",
                 "slot", "pages", "cancel_flag", "stream", "done",
                 "error", "prefix_nodes", "cached_len", "prefilling",
                 "chunk_done", "table_row")

    def __init__(self, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        self.id = next(_ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        # absolute monotonic completion deadline (None = never)
        self.deadline_s = deadline_s
        self.state = QUEUED
        self.tokens: List[int] = []
        self.submit_t = time.monotonic()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.slot: Optional[int] = None
        self.pages: List[int] = []          # PRIVATE pages (this req frees)
        self.prefix_nodes: List = []        # shared prefix-cache nodes
        self.cached_len = 0                 # tokens covered by prefix_nodes
        self.prefilling = False             # mid chunked-prefill (parked)
        self.chunk_done = 0                 # suffix tokens prefilled so far
        self.table_row = None               # real row while parked (the
        #                                     scheduler row is all-TRASH)
        self.cancel_flag = False
        self.stream: "queue.Queue" = queue.Queue()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s

    def finish(self, state: str) -> None:
        self.state = state
        self.finish_t = time.monotonic()
        self.stream.put(_END)
        self.done.set()


class RequestHandle:
    """Caller-side view: a token stream + a blocking result.

    Iterating yields tokens as the engine produces them; ``result()``
    blocks until the request retires and returns the full continuation
    (possibly shorter than max_new_tokens on EOS/cancel/timeout).
    """

    def __init__(self, req: Request):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.id

    @property
    def status(self) -> str:
        return self._req.state

    @property
    def tokens_so_far(self) -> List[int]:
        return list(self._req.tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        """submit -> first streamed token, seconds (None before then)."""
        if self._req.first_token_t is None:
            return None
        return self._req.first_token_t - self._req.submit_t

    def __iter__(self):
        while True:
            t = self._req.stream.get()
            if t is _END:
                # re-arm the sentinel: a second iteration must terminate
                # instead of blocking on the drained queue forever
                self._req.stream.put(_END)
                return
            yield t

    def cancel(self) -> None:
        """Request cancellation; the engine retires the slot (freeing its
        pages) at the next tick. Idempotent; no-op once finished."""
        self._req.cancel_flag = True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until retirement; returns the generated tokens
        (int32 1-D). Raises on engine-side errors."""
        if not self._req.done.wait(timeout):
            raise TimeoutError(
                f"request {self._req.id} not finished after {timeout}s")
        if self._req.error is not None:
            raise self._req.error
        return np.asarray(self._req.tokens, np.int32)


class Scheduler:
    """Slot + page bookkeeping for the engine's fixed decode batch.

    Not thread-safe by itself — the engine serializes all calls on its
    worker thread (submit() is the one cross-thread entry and only
    touches the locked queue).
    """

    def __init__(self, *, max_batch: int, pages_per_slot: int,
                 pool: PagePool, max_queue: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 prefix_cache=None, admission_window: int = 0):
        self.max_batch = int(max_batch)
        self.pages_per_slot = int(pages_per_slot)
        self.pool = pool
        self.max_queue = max_queue
        self.max_prompt_len = max_prompt_len
        # shared-prefix registry: admission attaches the longest cached
        # page-aligned prefix and allocates only the remainder;
        # retirement decrefs shared pages instead of freeing them
        self.prefix_cache = prefix_cache
        self.admission_window = int(admission_window)
        if self.admission_window < 0:
            raise ValueError("admission_window must be >= 0")
        # per-head overtake budget: counting overtakes per head makes the
        # advertised skip-ahead bound real under a stream of arrivals
        self._head_id: Optional[int] = None
        self._head_overtakes = 0
        self._lock = threading.Lock()
        self._queue: "deque[Request]" = deque()
        self.slots: List[Optional[Request]] = [None] * self.max_batch
        # host-side mirrors of the tick's table/length operands
        self.tables = np.zeros((self.max_batch, self.pages_per_slot),
                               np.int32)
        self.lengths = np.zeros((self.max_batch,), np.int32)

    # ------------------------------------------------------------ queue ----
    def pages_needed(self, req: Request) -> int:
        # every position a full generation can write: prompt plus
        # max_new_tokens - 1 generated tokens land in the cache (the last
        # sampled token is never written)
        need = req.prompt.size + req.max_new_tokens - 1
        return self.pool.pages_for_len(need)

    def submit(self, req: Request) -> bool:
        """Enqueue; False = rejected (queue full or request can never
        fit this engine's budgets)."""
        if self.pages_needed(req) > min(self.pages_per_slot,
                                        self.pool.total_pages - 1):
            return False
        if (self.max_prompt_len is not None
                and req.prompt.size > self.max_prompt_len):
            return False
        with self._lock:
            if self.max_queue is not None and len(self._queue) >= \
                    self.max_queue:
                return False
            self._queue.append(req)
        return True

    def queued(self) -> int:
        with self._lock:
            return len(self._queue)

    def drop_queued(self, pred) -> List[Request]:
        """Remove queued requests matching ``pred`` (cancel/timeout
        sweeps); returns them."""
        with self._lock:
            keep, dropped = deque(), []
            for r in self._queue:
                (dropped if pred(r) else keep).append(r)
            self._queue = keep
        return dropped

    # ------------------------------------------------------------ slots ----
    def live(self) -> List[Tuple[int, Request]]:
        """Slots in the DECODE batch (excludes parked mid-prefill ones)."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling]

    def occupied(self) -> List[Tuple[int, Request]]:
        """Every non-empty slot, decoding or mid-prefill."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def effective_row(self, slot: int) -> np.ndarray:
        """The table row whose pages belong to the slot's request: the
        stashed REAL row while the request is parked mid chunked-prefill
        (the scheduler row is then all-TRASH), else the live row."""
        req = self.slots[slot]
        if req is not None and req.table_row is not None:
            return req.table_row
        return self.tables[slot]

    @property
    def occupancy(self) -> float:
        return sum(r is not None for r in self.slots) / self.max_batch

    def _try_reserve(self, req: Request) -> bool:
        """Pin the longest cached prefix and allocate the request's
        private pages; True = fully funded. On failure every side
        effect is rolled back (pins released)."""
        if self.prefix_cache is not None:
            req.prefix_nodes = self.prefix_cache.acquire(req.prompt)
            req.cached_len = len(req.prefix_nodes) * self.pool.page_size
        need = self.pages_needed(req) - len(req.prefix_nodes)
        if not self.pool.can_alloc(need):
            # page pressure: reclaim refcount-0 cached prefixes (LRU
            # first) — only when that can actually admit this request
            if (self.prefix_cache is not None
                    and need <= self.pool.free_pages
                    + self.prefix_cache.reusable_pages):
                self.prefix_cache.evict(need - self.pool.free_pages)
            if not self.pool.can_alloc(need):
                if req.prefix_nodes:
                    self.prefix_cache.release(req.prefix_nodes)
                    req.prefix_nodes = []
                    req.cached_len = 0
                return False
        req.pages = self.pool.alloc(need)
        return True

    def admit(self) -> List[Tuple[int, Request]]:
        """Admit queued requests while a free slot AND their remaining
        (non-prefix-cached) page budget are available."""
        admitted = []
        while True:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = None
            with self._lock:
                if self._queue:
                    head = self._queue[0]
                    if head.id != self._head_id:
                        self._head_id = head.id
                        self._head_overtakes = 0
                budget = self.admission_window - self._head_overtakes
                for idx in range(min(len(self._queue), budget + 1)):
                    cand = self._queue[idx]
                    if self._try_reserve(cand):
                        del self._queue[idx]
                        if idx > 0:
                            self._head_overtakes += 1
                        req = cand
                        break
            if req is None:
                break
            slot = free[0]
            req.slot = slot
            req.admit_t = time.monotonic()
            req.state = RUNNING
            self.slots[slot] = req
            shared = [nd.page for nd in req.prefix_nodes]
            self.tables[slot, :] = PagePool.TRASH
            self.tables[slot, :len(shared)] = shared
            self.tables[slot, len(shared):len(shared) + len(req.pages)] = \
                req.pages
            self.lengths[slot] = 0  # set to prompt len after prefill
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int, state: str) -> Request:
        """Free the slot immediately; private pages return to the pool,
        shared prefix pages are DECREF'd (they stay cached for the next
        request with the same prefix); mark the request."""
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"retire(): slot {slot} is empty")
        if req.prefix_nodes:
            self.prefix_cache.release(req.prefix_nodes)
            req.prefix_nodes = []
        self.pool.free(req.pages)
        req.pages = []
        req.prefilling = False
        req.table_row = None
        self.slots[slot] = None
        self.tables[slot, :] = PagePool.TRASH
        self.lengths[slot] = 0
        req.finish(state)
        return req
