"""Continuous-batching generation engine over the paged KV cache.

Port of ``paddle_tpu/serving/engine.py`` (greedy decoding):

  - requests are admitted mid-flight into free slots of a fixed
    ``max_batch``-wide decode batch (page-budget-aware admission, see
    serving/scheduler.py);
  - admission first attaches the longest prefix-cached page-aligned
    span of the prompt (serving/prefix_cache.py) and only the uncached
    suffix is ever computed;
  - every engine tick is ONE ragged ``serving_tick`` call: each live
    slot's decode token AND up to a per-tick token budget of pending
    prompt spans run in the same pass, with sequence geometry carried
    as tensors, over the ragged paged-attention kernel;
  - ``prefill_chunk=N`` caps the per-tick prefill token budget (bounded
    inter-token stall for in-flight streams while long prompts are
    absorbed);
  - ``decode_block_size=k`` fuses k decode steps per pure-decode tick
    (``serving_tick_block``) and rides k-1 of them on admission ticks;
  - sequences retire at EOS / max_new_tokens / deadline / cancel and
    their pages return to the pool the same tick.

Correctness bar (tests/test_torch_serving.py): every request's greedy
tokens equal a standalone ``generate()`` run token for token, whatever
else shares the batch.

PyTorch runs eagerly, so the packed stream has exactly the tick's
tokens: the JAX engine's packed-width grid (which bounded its compiled
program set) has no role here.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..inference.paged_kv import PagePool
from ..models import llama
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .scheduler import (CANCELLED, COMPLETED, REJECTED, TIMED_OUT,
                        Request, RequestHandle, Scheduler)

__all__ = ["ServingEngine"]


class ServingEngine:
    """Continuous-batching serving engine (greedy).

        eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                            max_prompt_len=512, max_new_tokens_cap=32)
        h = eng.submit([1, 2, 3], max_new_tokens=16, eos_token_id=7)
        for tok in h:          # streams as decoded
            ...
        toks = h.result()      # or block for the full continuation
        eng.close()            # graceful drain

    params/cfg: Llama params (``models.llama``) on ``device`` + config.
    device: ``cuda`` by default; ``"cpu"`` only when asked (the tests).
    max_batch: decode slots.
    page_size/total_pages: the shared KV pool geometry. The default
    total_pages funds every slot's worst case; pass fewer to get
    admission backpressure.
    max_prompt_len / max_new_tokens_cap: per-request ceilings (they size
    the fixed page-table width).
    prefix_cache: True (default) keeps full prompt-KV pages registered
    across requests (refcounted, LRU-evicted under page pressure), so a
    shared prompt prefix is prefilled once.
    prefill_chunk: per-tick prefill token budget; None absorbs a whole
    suffix in its admission tick.
    decode_block_size: decode steps fused per tick.
    admission_window: 0 = strict FIFO admission; N lets up to N queued
    requests overtake a head whose page budget does not fit.
    """

    def __init__(self, params, cfg, *, device=None, max_batch: int = 8,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 max_prompt_len: int = 64, max_new_tokens_cap: int = 64,
                 max_queue: Optional[int] = None,
                 tick_interval_s: float = 0.0,
                 decode_block_size: int = 1, prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 admission_window: int = 0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if decode_block_size < 1:
            raise ValueError("decode_block_size must be >= 1")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self._dev = resolve_device(device)
        if params["embed"].device != self._dev:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self._dev}")
        self._params = params
        self._cfg = cfg
        # optional pacing between ticks (0 = back to back)
        self._tick_interval = float(tick_interval_s)
        self._decode_block = int(decode_block_size)
        max_prompt_len = int(max_prompt_len)
        pages_per_slot = -(-(max_prompt_len + int(max_new_tokens_cap) - 1)
                           // page_size)
        if total_pages is None:
            total_pages = max_batch * pages_per_slot + 1
        self.pool = PagePool(total_pages=total_pages, page_size=page_size)
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache \
            else None
        # per-tick prefill token budget
        self._budget = int(prefill_chunk) if prefill_chunk is not None \
            else max_prompt_len
        self.scheduler = Scheduler(
            max_batch=max_batch, pages_per_slot=pages_per_slot,
            pool=self.pool, max_queue=max_queue,
            max_prompt_len=max_prompt_len, prefix_cache=self.prefix_cache,
            admission_window=admission_window)
        self.metrics = ServingMetrics()
        pools = llama.init_serving_pages(cfg, total_pages, page_size,
                                         self._dev)
        self._kp, self._vp = pools["k_pages"], pools["v_pages"]
        # requests parked mid chunked-prefill, FIFO
        self._prefill_q: "deque" = deque()
        self._last_decode_t: Optional[float] = None
        self._cur_tok = np.zeros((max_batch,), np.int32)
        self._produced = np.zeros((max_batch,), np.int64)

        self._cond = threading.Condition()
        self._tick_lock = threading.Lock()
        self._closing = False
        self._drain = True
        self._dead: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._worker.start()

    # --------------------------------------------------------------- API ----
    def submit(self, prompt, max_new_tokens: int, *,
               eos_token_id: Optional[int] = None,
               timeout: Optional[float] = None,
               temperature: float = 0.0) -> RequestHandle:
        """Queue one request; returns a streaming handle. Raises
        RuntimeError when the request is REJECTED (queue full, or its
        prompt/page budget can never fit this engine)."""
        if temperature:
            raise NotImplementedError(
                "sampling (temperature > 0) is not ported yet: the fused "
                "in-graph sampler comes with a later slice of the port; "
                "this engine decodes greedily")
        if self._dead is not None:
            raise RuntimeError("engine worker died") from self._dead
        deadline = None if timeout is None else time.monotonic() + timeout
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      deadline_s=deadline)
        self.metrics.inc("submitted")
        with self._cond:
            if self._closing:
                raise RuntimeError("ServingEngine is closed")
            ok = self.scheduler.submit(req)
            if ok:
                self._cond.notify_all()
        if ok and self._dead is not None and not req.done.is_set():
            # the worker died between the liveness check and the
            # enqueue: nothing would ever resolve this handle
            req.error = self._dead
            req.finish(CANCELLED)
            raise RuntimeError("engine worker died") from self._dead
        if not ok:
            req.state = REJECTED
            self.metrics.inc("rejected")
            raise RuntimeError(
                f"request rejected: prompt {req.prompt.size} tokens + "
                f"{req.max_new_tokens} new needs "
                f"{self.scheduler.pages_needed(req)} pages "
                f"(slot budget {self.scheduler.pages_per_slot}, max "
                f"prompt {self.scheduler.max_prompt_len}) or queue full")
        return RequestHandle(req)

    def generate(self, prompt, max_new_tokens: int, **kw) -> np.ndarray:
        """Blocking convenience: submit + wait; returns the generated
        tokens (no prompt prefix)."""
        return self.submit(prompt, max_new_tokens, **kw).result()

    def close(self, drain: bool = True) -> None:
        """Stop admission and shut down. drain=True (default) finishes
        every queued + running request first; drain=False cancels
        them."""
        with self._cond:
            self._closing = True
            self._drain = drain
            self._cond.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        """Plain-dict metrics snapshot plus live pool/queue gauges (read
        under the tick lock, so never a torn view of the scheduler)."""
        snap = self.metrics.snapshot()
        with self._tick_lock:
            g = {"queued": self.scheduler.queued(),
                 "occupancy": self.scheduler.occupancy,
                 "page_utilization": self.pool.utilization,
                 "free_pages": self.pool.free_pages}
            if self.prefix_cache is not None:
                g["prefix_cache"] = self.prefix_cache.stats()
        snap["gauges"] = g
        return snap

    # ------------------------------------------------------------ tokens ----
    def _emit(self, slot: int, req: Request, tok: int) -> bool:
        """Stream one token; True when the request just finished (EOS or
        max_new_tokens)."""
        now = time.monotonic()
        if req.first_token_t is None:
            req.first_token_t = now
            self.metrics.observe("ttft_s", now - req.submit_t)
        req.tokens.append(tok)
        req.stream.put(tok)
        self._produced[slot] += 1
        self.metrics.inc("tokens_out")
        return bool(self._produced[slot] >= req.max_new_tokens
                    or (req.eos_token_id is not None
                        and tok == req.eos_token_id))

    def _retire(self, slot: int, state: str) -> None:
        self.scheduler.retire(slot, state)
        self._cur_tok[slot] = 0
        self._produced[slot] = 0
        self.metrics.inc({COMPLETED: "completed", CANCELLED: "cancelled",
                          TIMED_OUT: "timed_out"}[state])

    def _emit_toks(self, slot: int, req: Request, toks_row,
                   j0: int, j1: int) -> None:
        """Emit ``toks_row[j0:j1]`` (fused block/tail tokens), retiring at
        the first completion; the rest are discarded (their KV landed on
        the trash page or past the length)."""
        for j in range(j0, j1):
            t = int(toks_row[j])
            self._cur_tok[slot] = t
            if self._emit(slot, req, t):
                self._retire(slot, COMPLETED)
                break

    # ----------------------------------------------------------- prefill ----
    def _park(self, slot: int, req: Request) -> None:
        """Admission: park the slot until its prompt is fully cached. The
        real table row moves onto the request and the scheduler row goes
        all-TRASH (length 0): the parked slot is DEAD to the fused block
        (its writes land on the trash page) while each tick's ragged
        metadata addresses the stashed real row directly."""
        if req.cached_len:
            self.metrics.inc("prefix_hits")
            self.metrics.inc("prefix_hit_tokens", req.cached_len)
            self.metrics.inc("prefix_pages_saved", len(req.prefix_nodes))
        elif self.prefix_cache is not None:
            self.metrics.inc("prefix_misses")
        req.prefilling = True
        req.chunk_done = 0
        req.table_row = self.scheduler.tables[slot].copy()
        self.scheduler.tables[slot, :] = PagePool.TRASH
        self._prefill_q.append((slot, req))

    def _collect_spans(self):
        """The tick's prefill work: FIFO over parked requests, capped at
        the per-tick token budget. Returns [(slot, req, start, take)];
        advances no state. A later request gets budget only once every
        earlier one's span completed its prompt, so finishing spans are
        always a prefix of the queue."""
        while self._prefill_q:          # drop entries retired by sweeps
            slot, req = self._prefill_q[0]
            if self.scheduler.slots[slot] is req and req.prefilling:
                break
            self._prefill_q.popleft()
        spans, left = [], self._budget
        for slot, req in self._prefill_q:
            if left <= 0:
                break
            if self.scheduler.slots[slot] is not req or not req.prefilling:
                continue
            remaining = req.prompt.size - req.cached_len - req.chunk_done
            take = min(remaining, left)
            if take <= 0:
                continue
            spans.append((slot, req, req.cached_len + req.chunk_done,
                          take))
            left -= take
            if take < remaining:
                break                   # budget exhausted mid-prompt
        return spans

    def _finish_prefill(self, slot: int, req: Request, tok: int) -> None:
        """Prefill tail: re-install the real row, register the prompt's
        full pages in the prefix cache, join the decode batch, emit the
        first token."""
        n = req.prompt.size
        self.metrics.inc("prefills")
        req.prefilling = False
        self.scheduler.tables[slot, :] = req.table_row
        req.table_row = None
        if self.prefix_cache is not None:
            new_full = n // self.pool.page_size - len(req.prefix_nodes)
            if new_full > 0:
                adopted, dup = self.prefix_cache.insert(
                    req.prompt, req.prefix_nodes, req.pages[:new_full])
                req.prefix_nodes = req.prefix_nodes + adopted
                req.pages = dup + req.pages[new_full:]
        self.scheduler.lengths[slot] = n
        self._cur_tok[slot] = tok
        if self._emit(slot, req, tok):
            self._retire(slot, COMPLETED)

    # -------------------------------------------------------------- tick ----
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._dev)

    def _ragged_tick(self, live, spans, tail: int = 0) -> None:
        """ONE serving_tick call covering every live slot's decode token
        plus the collected prompt spans. The packed stream is the S
        decode positions (slot i at index i, padding where idle)
        followed by the spans. ``tail`` fuses that many extra decode
        steps for tail-live slots — decoding slots plus spans
        COMPLETING their prompt this tick (mid-prefill slots sit the
        tail out on the trash page)."""
        S = self.scheduler.max_batch
        tail_live = np.zeros((S,), bool)
        tabs = np.stack([self.scheduler.effective_row(s)
                         for s in range(S)])
        for slot, _ in live:
            tail_live[slot] = True
        for slot, req, start, take in spans:
            tail_live[slot] = start + take >= req.prompt.size
        if not tail_live.any():
            tail = 0    # nobody would advance
        tok, meta = llama.pack_tick(
            [(slot, self._cur_tok[slot], self.scheduler.lengths[slot])
             for slot, _ in live],
            [(slot, req.prompt[start:start + take], start)
             for slot, req, start, take in spans],
            tabs, self.pool.page_size, self._dev)
        meta["tail_live"] = self._to_dev(tail_live)
        t0 = time.perf_counter()
        toks, _, self._kp, self._vp = llama.serving_tick(
            self._params, tok, meta, self._kp, self._vp, self._cfg,
            decode_tail=tail)
        toks = toks.cpu().numpy()       # the one host read-back per tick
        self.metrics.inc("model_steps", 1 + tail)
        if toks.ndim == 1:
            toks = toks[:, None]
        if live:
            self.metrics.inc("decode_steps", 1 + tail)
            self.metrics.observe("decode_step_s",
                                 (time.perf_counter() - t0) / (1 + tail))
        for slot, req in live:
            self.scheduler.lengths[slot] += 1 + tail
            t = int(toks[slot, 0])
            self._cur_tok[slot] = t
            if self._emit(slot, req, t):
                self._retire(slot, COMPLETED)
                continue
            self._emit_toks(slot, req, toks[slot], 1, 1 + tail)
        for slot, req, start, take in spans:
            req.chunk_done += take
            self.metrics.inc("prefill_chunks")
            if req.cached_len + req.chunk_done >= req.prompt.size:
                if self._prefill_q and self._prefill_q[0][1] is req:
                    self._prefill_q.popleft()
                self._finish_prefill(slot, req, int(toks[slot, 0]))
                if tail and self.scheduler.slots[slot] is req:
                    # the completing slot rode the tail too
                    self.scheduler.lengths[slot] += tail
                    self._emit_toks(slot, req, toks[slot], 1, 1 + tail)

    def _block_tick(self, live) -> None:
        """Pure-decode ticks: ``decode_block_size`` fused greedy steps in
        one call. Fused ticks always run the FULL block; tokens past a
        retirement are discarded (their KV lands on the trash page or
        past the length)."""
        k = self._decode_block
        t0 = time.perf_counter()
        toks, self._kp, self._vp = llama.serving_tick_block(
            self._params, self._to_dev(self._cur_tok),
            self._to_dev(self.scheduler.lengths),
            self._to_dev(self.scheduler.tables), self._kp, self._vp,
            self._cfg, num_steps=k)
        toks = toks.cpu().numpy()
        self.metrics.inc("model_steps", k)
        self.metrics.inc("decode_steps", k)
        self.metrics.observe("decode_step_s",
                             (time.perf_counter() - t0) / k)
        for slot, req in live:
            self.scheduler.lengths[slot] += k  # the block's KV landed
            self._emit_toks(slot, req, toks[slot], 0, k)

    def _decode_tick(self, live, spans) -> None:
        """The fused block when the tick is pure decode, else the ragged
        tick with the fused decode tail."""
        if not spans and live:
            self._block_tick(live)
        elif spans:
            self._ragged_tick(live, spans, self._decode_block - 1)

    def _sweep(self, now: float) -> None:
        """Apply cancellations + deadlines to queued and occupied
        (decoding OR mid-prefill) requests."""
        for r in self.scheduler.drop_queued(
                lambda r: r.cancel_flag or r.expired(now)):
            r.finish(CANCELLED if r.cancel_flag else TIMED_OUT)
            self.metrics.inc("cancelled" if r.cancel_flag else "timed_out")
        for slot, req in self.scheduler.occupied():
            if req.cancel_flag:
                self._retire(slot, CANCELLED)
            elif req.expired(now):
                self._retire(slot, TIMED_OUT)

    def _loop(self) -> None:
        dev_ctx = (torch.cuda.device(self._dev) if self._dev.type == "cuda"
                   else contextlib.nullcontext())
        try:
            with dev_ctx:
                self._run()
        except BaseException as e:  # fail every caller, then surface
            self._dead = e
            with self._tick_lock:
                self._fail_all(e)
            raise
        finally:
            # post-drain (or cancel-close): flush whatever remains
            with self._tick_lock:
                for r in self.scheduler.drop_queued(lambda r: True):
                    r.finish(CANCELLED)
                    self.metrics.inc("cancelled")
                for slot, _ in self.scheduler.occupied():
                    self._retire(slot, CANCELLED)
                self._prefill_q.clear()
                if self.prefix_cache is not None:
                    # every request is retired: return the cached pages
                    # so the pool ends balanced
                    self.prefix_cache.evict(self.prefix_cache.cached_pages)

    def _run(self) -> None:
        while True:
            with self._tick_lock:
                now = time.monotonic()
                self._sweep(now)
                if self._closing and not self._drain:
                    break
                for slot, req in self.scheduler.admit():
                    self.metrics.inc("admitted")
                    self.metrics.observe("queue_wait_s",
                                         req.admit_t - req.submit_t)
                    self._park(slot, req)
                spans = self._collect_spans()
                live = self.scheduler.live()
                self.metrics.observe("batch_occupancy",
                                     self.scheduler.occupancy)
                self.metrics.observe("page_utilization",
                                     self.pool.utilization)
                self.metrics.observe("chunk_queue_depth",
                                     len(self._prefill_q))
                ticked = bool(live) or bool(spans)
                if ticked:
                    # inter-decode-tick stall: everything since the last
                    # tick ended is the latency live streams feel
                    t = time.perf_counter()
                    if live and self._last_decode_t is not None:
                        self.metrics.observe("decode_stall_s",
                                             t - self._last_decode_t)
                    self._decode_tick(live, spans)
                    self.metrics.inc("ticks")
                    self._last_decode_t = (time.perf_counter()
                                           if live else None)
                else:
                    self._last_decode_t = None
            if ticked:
                # pace OUTSIDE the tick lock
                if self._tick_interval:
                    time.sleep(self._tick_interval)
                continue
            # idle: nothing live — wait for work or shutdown
            with self._cond:
                if self.scheduler.queued():
                    continue
                if self._closing:
                    break
                self._cond.wait(timeout=0.05)

    def _fail_all(self, e: BaseException) -> None:
        for r in self.scheduler.drop_queued(lambda r: True):
            r.error = e
            r.finish(CANCELLED)
        for slot, req in self.scheduler.occupied():
            req.error = e
            self.scheduler.retire(slot, CANCELLED)
