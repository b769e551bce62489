"""Continuous-batching generation engine over the paged KV cache.

Port of ``paddle_tpu/serving/engine.py``:

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
    their pages return to the pool the same tick;
  - ``submit(temperature, top_p, top_k, seed)`` samples in the tick
    (``llama._fused_sample``): token ``n`` of a request is drawn with
    ``fold_in(key(seed), n)``, so one seed gives one stream whatever
    shares the batch; a tick whose requests are all greedy launches
    nothing of the sampler;
  - ``speculative=...`` drafts up to ``spec_k`` tokens a live slot
    (serving/speculative.py) and verifies them in the same ragged tick
    (``serving_tick``'s ``spec_k`` mode), emitting ``1 + accepted``
    tokens a launch;
  - ``defragment()`` compacts the live pages, ``expose()`` renders the
    metrics as Prometheus text;
  - the model module comes from ``model=`` or the config's type
    (``llama``, ``qwen2_moe``): its ``init_serving_pages``,
    ``serving_tick`` and ``serving_tick_block`` run the ticks, and
    ``llama.pack_tick`` packs them for every model.

Correctness bar (tests/test_torch_serving.py, test_torch_sampling.py,
test_torch_speculative.py): every request's greedy tokens equal a
standalone ``generate()`` run token for token, whatever else shares the
batch, with or without speculation, before or after a defrag; a sampled
request's tokens are the same stream alone, beside neighbours, under any
decode block and on a speculative engine, and equal the JAX engine's.

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
from ..inference.paged_kv import PagePool, apply_defrag
from ..models import llama, qwen2_moe
from ..quantization.decode import is_quantized_params, quantize_for_decode
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .scheduler import (CANCELLED, COMPLETED, REJECTED, TIMED_OUT,
                        Request, RequestHandle, Scheduler)
from .speculative import AcceptancePolicy, resolve_drafter

__all__ = ["ServingEngine"]


def _resolve_model(model, cfg):
    """The model module that serves ``cfg``: a module-like ``model`` as
    given (it provides ``init_serving_pages``, ``serving_tick`` and
    ``serving_tick_block`` with the port's signatures), else the name
    ``model`` or, when None, the config's type name: ``llama`` or
    ``qwen2_moe``. Anything else raises ``ValueError``."""
    if model is not None and not isinstance(model, str):
        return model
    name = model or type(cfg).__name__
    if "llama" in name.lower():
        return llama
    if "qwen2moe" in name.lower().replace("_", ""):
        return qwen2_moe
    raise ValueError(
        f"cannot infer serving model from {name!r}; pass model='llama', "
        "'qwen2_moe', or a module exposing init_serving_pages/"
        "serving_tick/serving_tick_block")


class ServingEngine:
    """Continuous-batching serving engine.

        eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                            max_prompt_len=512, max_new_tokens_cap=32)
        h = eng.submit([1, 2, 3], max_new_tokens=16, eos_token_id=7)
        for tok in h:          # streams as decoded
            ...
        toks = h.result()      # or block for the full continuation
        eng.close()            # graceful drain

    params/cfg: the model's params on ``device`` + config (Llama or
    Qwen2-MoE).
    model: None (from the config's type), ``"llama"``, ``"qwen2_moe"`` or
    a module-like object with the serving functions (``_resolve_model``).
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
    quantization: None / ``"none"`` (the params as given) or ``"int8"``
    — weight-only int8 decode: the params are quantized at construction
    (``quantization.quantize_for_decode``) unless they already are, and
    every projection runs through the int8 matmul kernel.
    speculative: None (off); True / ``"ngram"`` (``NGramDrafter``,
    prompt lookup over the request's own history); an object with
    ``propose(history, k) -> tokens`` or a bare callable of that
    signature. Every live slot may then submit its current token and up
    to ``spec_k`` drafts as a span of the tick; the tick verifies them
    against its own picks (argmax, or the sampler's draw) and the slot
    emits ``1 + accepted`` tokens. Outputs equal the plain engine's
    whatever the drafter proposes. A per-request acceptance EWMA sets
    each slot's draft budget (``AcceptancePolicy``). Every tick with
    drafts or prompt spans is a verify tick (no fused tail); a
    pure-decode tick with no drafts runs the fused block.
    spec_k: the draft-length cap.
    """

    def __init__(self, params, cfg, *, model=None, device=None,
                 max_batch: int = 8,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 max_prompt_len: int = 64, max_new_tokens_cap: int = 64,
                 max_queue: Optional[int] = None,
                 tick_interval_s: float = 0.0,
                 decode_block_size: int = 1, prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 admission_window: int = 0,
                 quantization: Optional[str] = None,
                 speculative=None, spec_k: int = 3):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if decode_block_size < 1:
            raise ValueError("decode_block_size must be >= 1")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if quantization not in (None, "none", "int8"):
            raise ValueError(f"quantization must be None/'none'/'int8', "
                             f"got {quantization!r}")
        self._mod = _resolve_model(model, cfg)
        self._dev = resolve_device(device)
        if params["embed"].device != self._dev:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self._dev}")
        if quantization == "int8" and not is_quantized_params(params):
            params = quantize_for_decode(params, cfg)
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
        # speculative decoding: drafter + per-request adaptive-k policy
        self._drafter = resolve_drafter(speculative)
        if self._drafter is not None and int(spec_k) < 1:
            raise ValueError(f"spec_k must be >= 1 when speculative "
                             f"decoding is on, got {spec_k}")
        self._spec_k = int(spec_k) if self._drafter is not None else 0
        self._spec_policy = (AcceptancePolicy(self._spec_k)
                             if self._drafter is not None else None)
        pools = self._mod.init_serving_pages(cfg, total_pages, page_size,
                                             self._dev)
        self._kp, self._vp = pools["k_pages"], pools["v_pages"]
        # requests parked mid chunked-prefill, FIFO
        self._prefill_q: "deque" = deque()
        self._last_decode_t: Optional[float] = None
        self._cur_tok = np.zeros((max_batch,), np.int32)
        self._produced = np.zeros((max_batch,), np.int64)
        # each slot's raw key (0, seed & 0xffffffff), set at admission and
        # constant for the request's life: the tick folds the token's
        # continuation index in, so no split chain advances on the host
        self._key_data = np.zeros((max_batch, 2), np.int64)
        # the sampling arrays on the device for the current batch
        # composition ({} when no request samples); None = rebuild
        self._samp_cache: Optional[dict] = None

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
               temperature: float = 0.0, top_p: float = 1.0,
               top_k: int = 0, seed: int = 0) -> RequestHandle:
        """Queue one request; returns a streaming handle. Raises
        RuntimeError when the request is REJECTED (queue full, or its
        prompt/page budget can never fit this engine).
        ``temperature`` (0 = greedy), ``top_p`` (1.0 = off), ``top_k``
        (0 = off) and ``seed`` are the request's sampling state: a fixed
        seed gives one token stream whatever else shares the batch."""
        if self._dead is not None:
            raise RuntimeError("engine worker died") from self._dead
        deadline = None if timeout is None else time.monotonic() + timeout
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      deadline_s=deadline, temperature=temperature,
                      top_p=top_p, top_k=top_k, seed=seed)
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

    def _gauges(self) -> dict:
        """Live pool/queue gauges. The caller holds ``_tick_lock``: the
        slot list, free list and trie change mid-tick."""
        g = {"queued": self.scheduler.queued(),
             "occupancy": self.scheduler.occupancy,
             "page_utilization": self.pool.utilization,
             "free_pages": self.pool.free_pages}
        if self.prefix_cache is not None:
            g["prefix_cache"] = self.prefix_cache.stats()
        return g

    def stats(self) -> dict:
        """Plain-dict metrics snapshot plus live pool/queue gauges (read
        under the tick lock, so never a torn view of the scheduler)."""
        snap = self.metrics.snapshot()
        with self._tick_lock:
            snap["gauges"] = self._gauges()
        return snap

    def gauges(self) -> dict:
        """Flat ``{name: number}`` view of the live gauges (nested
        dicts, such as the prefix-cache stats, flattened to
        ``prefix_cache_<k>``); thread-safe like :meth:`stats`."""
        with self._tick_lock:
            g = self._gauges()
        flat = {}
        for k, v in g.items():
            if isinstance(v, dict):
                flat.update({f"{k}_{kk}": vv for kk, vv in v.items()
                             if isinstance(vv, (int, float))})
            elif isinstance(v, (int, float)):
                flat[k] = v
        return flat

    def expose(self, labels: Optional[dict] = None) -> str:
        """Prometheus text exposition of the counters, histograms and
        live gauges (``ServingMetrics.expose``); ``labels`` (raw,
        unescaped) are stamped on every sample."""
        return self.metrics.expose(gauges=self.gauges(), labels=labels)

    def defragment(self) -> int:
        """Compact the live pages to the pool's low indices: rewrites the
        pools and every slot's table row (``apply_defrag``), the
        requests' page lists and parked requests' stashed rows
        (``Scheduler.remap_pages``) and the prefix cache's pages
        (``PrefixCache.remap``), then commits the plan to the allocator.
        Returns the number of pages moved. Safe mid-generation: it runs
        under the tick lock, between ticks.

        Left out until their modules are ported: the invariants audit of
        the plan and of the state after it, with its postmortem
        (``kv_invariants``), and the remap of pending chunked adopts
        (the cold tier's chain export/adopt)."""
        with self._tick_lock:
            plan = self.pool.defrag_plan()
            if not plan:
                return 0
            self._kp, self._vp, tables = apply_defrag(
                plan, self._kp, self._vp, self.scheduler.tables)
            self.scheduler.tables = np.array(tables.numpy(), np.int32)
            self.scheduler.remap_pages(plan)
            if self.prefix_cache is not None:
                self.prefix_cache.remap(plan)
            self.pool.commit_defrag(plan)
            return len(plan)

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
        self._key_data[slot] = 0
        self._samp_cache = None
        self.metrics.inc({COMPLETED: "completed", CANCELLED: "cancelled",
                          TIMED_OUT: "timed_out"}[state])

    def _emit_toks(self, slot: int, req: Request, toks_row,
                   j0: int, j1: int) -> None:
        """Emit ``toks_row[j0:j1]`` (fused block, tail or verify
        tokens), retiring at the first completion; the rest are
        discarded (their KV landed on the trash page or past the length;
        a discarded sampled token burns no key state, since draws are
        keyed by continuation index)."""
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
        # the slot's constant sampling key, JAX's PRNGKey(seed) (the mask
        # runs on the Python int)
        self._key_data[slot] = (0, req.seed & 0xFFFFFFFF)
        self._samp_cache = None
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

    # ------------------------------------------------------- speculation ----
    def _collect_drafts(self, live):
        """The tick's draft side (host, model-free by default): up to
        ``policy.budget(...)`` next tokens per live slot, sampling slots
        included (the verify pass draws the target's own sampled token
        at every span position). Returns ``{slot: int32[k_s]}`` with
        ``1 <= k_s <= spec_k``; slots with no entry decode plainly. The
        budget is ``max_new_tokens - produced - 1``: positions past it
        are not funded by the slot's pages."""
        drafts = {}
        # a drafter that declares its history window gets only that tail
        window = getattr(self._drafter, "max_history", None)
        for slot, req in live:
            remaining = req.max_new_tokens - int(self._produced[slot]) - 1
            k = self._spec_policy.budget(req, remaining)
            if k <= 0:
                continue
            toks = req.tokens if window is None else req.tokens[-window:]
            parts = [np.asarray(toks, np.int32)]
            if window is None or len(toks) < window:
                need = None if window is None else window - len(toks)
                parts.insert(0, req.prompt if need is None
                             else req.prompt[-need:])
            d = np.asarray(self._drafter.propose(np.concatenate(parts), k),
                           np.int32).reshape(-1)[:k]
            if d.size:
                drafts[slot] = d
        return drafts

    # -------------------------------------------------------------- tick ----
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._dev)

    def _sampling_arrays(self) -> dict:
        """The tick's sampling arrays (``serving_tick``'s ``temp``,
        ``top_p``, ``top_k``, ``key``, ``produced``), or ``{}`` when no
        occupied slot samples: the host's flag, read with no device sync,
        that keeps an all-greedy tick free of the sampler. The arrays
        that depend on the batch composition are cached on the device
        and rebuilt after an admission or a retirement (``_park`` /
        ``_retire``); only ``produced`` is uploaded each tick."""
        if self._samp_cache is None:
            S = self.scheduler.max_batch
            temp = np.zeros((S,), np.float32)
            top_p = np.ones((S,), np.float32)
            top_k = np.zeros((S,), np.int32)
            for slot, req in enumerate(self.scheduler.slots):
                if req is not None:
                    temp[slot] = req.temperature
                    top_p[slot] = req.top_p
                    top_k[slot] = req.top_k
            self._samp_cache = (
                dict(temp=self._to_dev(temp), top_p=self._to_dev(top_p),
                     top_k=self._to_dev(top_k),
                     key=self._to_dev(self._key_data))
                if (temp > 0).any() else {})
        if not self._samp_cache:
            return {}
        return dict(self._samp_cache, produced=self._to_dev(
            self._produced.astype(np.int32)))

    def _ragged_tick(self, live, spans, tail: int = 0,
                     drafts=None) -> None:
        """ONE serving_tick call covering every live slot's decode token
        plus the collected prompt spans. The packed stream is the S
        decode positions (slot i at index i, padding where idle)
        followed by the spans. ``tail`` fuses that many extra decode
        steps for tail-live slots — decoding slots plus spans
        COMPLETING their prompt this tick (mid-prefill slots sit the
        tail out on the trash page).

        ``drafts`` (``{slot: draft tokens}``, speculative engines) packs
        each drafted slot's current token and drafts as a span; every
        span-carrying tick of a speculative engine is a verify tick
        (``spec_k`` mode, no tail). A drafted slot's length advances by
        ``1 + accept`` and it emits ``toks[:accept + 1]``; rejected
        drafts' KV stays past the length, so nothing is rolled back."""
        S = self.scheduler.max_batch
        drafts = drafts or {}
        spec = self._spec_k if (drafts or spans) else 0
        if spec:
            tail = 0    # speculation replaces the fused decode tail
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
             for slot, _ in live if slot not in drafts],
            [(slot, req.prompt[start:start + take], start)
             for slot, req, start, take in spans],
            tabs, self.pool.page_size, self._dev,
            drafts=[(slot, self._cur_tok[slot],
                     self.scheduler.lengths[slot], drafts[slot])
                    for slot, _ in live if slot in drafts],
            spec_k=spec)
        meta["tail_live"] = self._to_dev(tail_live)
        meta.update(self._sampling_arrays())
        t0 = time.perf_counter()
        if spec:
            toks, accept, _, self._kp, self._vp = self._mod.serving_tick(
                self._params, tok, meta, self._kp, self._vp, self._cfg,
                spec_k=spec)
            accept = accept.cpu().numpy()
        else:
            toks, _, self._kp, self._vp = self._mod.serving_tick(
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
        if drafts:
            self.metrics.inc("spec_ticks")
        for slot, req in live:
            d = drafts.get(slot)
            if d is not None:
                k_s, a = int(d.size), int(accept[slot])
                self.scheduler.lengths[slot] += 1 + a
                self.metrics.inc("draft_tokens", k_s)
                self.metrics.inc("draft_accepted", a)
                self.metrics.inc("draft_rejected", k_s - a)
                self.metrics.observe("spec_accept_rate", a / k_s)
                self._spec_policy.update(req, k_s, a)
                self._emit_toks(slot, req, toks[slot], 0, a + 1)
                continue
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
        """Pure-decode ticks: ``decode_block_size`` fused steps in one
        call, sampling slots drawing in the tick. Fused ticks always run
        the FULL block; tokens past a retirement are discarded (their KV
        lands on the trash page or past the length)."""
        k = self._decode_block
        t0 = time.perf_counter()
        toks, self._kp, self._vp = self._mod.serving_tick_block(
            self._params, self._to_dev(self._cur_tok),
            self._to_dev(self.scheduler.lengths),
            self._to_dev(self.scheduler.tables), self._kp, self._vp,
            self._cfg, num_steps=k, sampling=self._sampling_arrays())
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
        tick with the fused decode tail. A speculative engine runs the
        verify tick whenever there are drafts or prompt spans; a tick
        with neither falls through to the fused block (slots whose
        acceptance degraded them to no drafts)."""
        if self._drafter is not None:
            drafts = self._collect_drafts(live)
            if drafts or spans:
                self._ragged_tick(live, spans, 0, drafts)
                return
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
