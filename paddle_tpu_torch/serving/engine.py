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
  - a cached prefix chain moves between engines, whole
    (``export_chain`` / ``adopt_chain``) or in chunks between ticks
    (``export_chain_begin/_chunk/_end``,
    ``adopt_chain_begin/_chunk/_commit/_abort``), and with
    ``cold_tier_bytes`` evicted chains page out to host RAM and rewarm
    on a later prefix match;
  - ``check_invariants`` audits the paged-KV bookkeeping
    (``analysis/kv_invariants.py``) after every tick and around every
    defrag; ``alive``, ``inject``, ``close(hand_back=True)``,
    ``snapshot``, ``affinity_summary`` and ``on_chain_complete`` are the
    surface a fleet drives (serving/fleet/);
  - runtime observability (``paddle_tpu_torch/observability``): every
    tick records engine-phase and per-slot lifecycle spans into a
    bounded ring (``export_trace(path)`` -> Perfetto) and a flight
    record; a ``KVInvariantError`` or an engine-loop crash writes a JSON
    postmortem (``postmortem_path``); the recompile sentinel turns a
    kernel library loaded after ``arm_sentinel()`` into a named WARN
    metric and a ``RecompileWarning``. ``warm_programs()`` loads every
    library of the engine's inventory before it is armed. Ticks and
    admissions are ``profiler.RecordEvent`` spans (``serving.tick``,
    ``serving.decode_step``, ``serving.admit``, the JAX engine's sites:
    ``torch.profiler`` ranges, ``host_statistics``, bridged into a
    ``SpanTracer`` by ``observability.bridge_record_events``); the loop
    takes up ``FLAGS_check_nan_inf`` once a turn (``amp.debugging``), and
    every serving lock goes through ``locktrace.wrap_lock``;
  - the model module comes from ``model=`` or the config's type
    (``llama``, ``qwen2_moe``): its ``init_serving_pages``,
    ``serving_tick`` and ``serving_tick_block`` run the ticks, and
    ``llama.pack_tick`` packs them for every model.

Correctness bar (tests/test_torch_serving.py, test_torch_sampling.py,
test_torch_speculative.py, test_torch_migration.py), in f32 (the CPU
tests): every request's greedy tokens equal a standalone ``generate()``
run token for token, whatever else shares the batch, with or without
speculation, before or after a defrag, over adopted or rewarmed pages;
a sampled request's tokens are the same stream alone, beside
neighbours, under any decode block and on a speculative engine, and
equal the JAX engine's. In bf16 on the card only this holds: a request
run alone on an engine streams the same tokens as the same request run
alone on the same engine, bitwise. Beside other requests it may leave
that stream (and a lone ``generate()``) wherever two logits sit within
a bf16 rounding: the dense products go to cuBLAS, whose rows are not
invariant across batch shapes.

PyTorch runs eagerly, so the packed stream has exactly the tick's
tokens: the JAX engine's packed-width grid (which bounded its compiled
program set) has no role here.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..analysis.kv_invariants import (KVInvariantError, audit_defrag_plan,
                                      audit_serving_state)
from ..amp import debugging
from ..device import resolve_device
from ..inference.paged_kv import PagePool, apply_defrag
from ..models import llama, qwen2_moe
from ..observability import FlightRecorder, RecompileSentinel, SpanTracer
from ..profiler import RecordEvent
from ..quantization.decode import is_quantized_params, quantize_for_decode
from .locktrace import get_tracer, host_sync, wrap_lock
from .metrics import ServingMetrics
from .prefix_cache import ColdTier, PrefixCache, _fp_extend
from .scheduler import (CANCELLED, COMPLETED, REJECTED, TIMED_OUT,
                        Request, RequestHandle, Scheduler)
from .speculative import AcceptancePolicy, resolve_drafter

__all__ = ["ServingEngine"]


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def _gather(pool: torch.Tensor, pages) -> torch.Tensor:
    """Pages ``[L, Hkv, n, ps, Dh]`` of a pool, copied to the host."""
    idx = torch.tensor(list(pages), dtype=torch.long, device=pool.device)
    return torch.index_select(pool, 2, idx).cpu()


def _host_pages(pool: torch.Tensor, pages) -> np.ndarray:
    """Pages ``[L, Hkv, n, ps, Dh]`` of a pool as a migration blob's
    numpy array: an f32 pool's as float32, a bf16 pool's bit patterns as
    ``np.uint16`` (numpy has no bfloat16)."""
    t = _gather(pool, pages)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float32:
        return t.numpy()
    raise ValueError(f"no migration blob dtype for a {t.dtype} pool")


def _blob_tensor(a, pool: torch.Tensor, n_pages: int) -> torch.Tensor:
    """A blob's ``k`` or ``v`` as a CPU tensor of the pool's dtype:
    float32 into an f32 pool, any 2-byte array (``uint16`` or ``int16``
    bits, or a bfloat16 array from the JAX package) into a bf16 pool, of
    shape ``[L, Hkv, n_pages, ps, Dh]``. Anything else raises
    ValueError."""
    a = np.asarray(a)
    bf16 = pool.dtype == torch.bfloat16
    if bf16 and a.dtype.itemsize == 2 and (a.dtype.kind in "ui"
                                           or a.dtype.name == "bfloat16"):
        a = a.view(np.int16)
    elif bf16 or not (pool.dtype == torch.float32
                      and a.dtype == np.float32):
        raise ValueError(f"blob dtype {a.dtype} does not fit this "
                         f"engine's {pool.dtype} KV pool")
    want = tuple(pool.shape[:2]) + (int(n_pages),) + tuple(pool.shape[3:])
    if tuple(a.shape) != want:
        raise ValueError(f"blob pages of shape {tuple(a.shape)}, this "
                         f"engine's pool takes {want}")
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


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
    check_invariants: True audits the paged-KV bookkeeping
    (``analysis/kv_invariants.py``: page ownership, trie refcounts, dead
    parked rows, in-flight transfers) after every tick and around every
    defrag; a violation raises ``KVInvariantError`` and fails the engine
    through its fail path. The default comes from
    ``PADDLE_TPU_SERVING_CHECK_INVARIANTS`` (the test suite sets it).
    A violation (or any other engine-loop failure) also writes the
    flight recorder's postmortem (see ``flight_ticks``).
    cold_tier_bytes: 0 (off) or a host-RAM budget for the cold tier
    (``ColdTier``): refcount-0 chains evicted under page pressure page
    out to host memory, keyed by chain fingerprint, and a queued prompt
    whose warm trie match ends where a spilled chain begins re-adopts
    those pages before admission instead of recomputing them (bitwise a
    warm hit: the bytes are the ones the device computed; the token
    tuples are compared before anything is adopted). Counters
    cold_hits / cold_hit_pages / cold_spills, histogram cold_adopt_s.
    on_chain_complete: optional ``fn(req, info)`` called (tick lock
    held: keep it cheap) when a prefill registers or extends a prefix
    chain; ``info`` is ``{"fp", "fps", "pages", "prompt_tokens"}``, the
    deepest chain fingerprint and the per-page ones, from the prompt.
    trace: span tracing (observability/tracer.py): per-tick engine phase
    spans (admission, the tick, defrag, the invariant audit) and
    per-request lifecycle spans (queue -> prefill chunks -> decode ticks
    -> retire) on one track per slot, ring-bounded (``trace_capacity``
    spans), exported as Perfetto JSON by ``export_trace(path)``. Default
    from ``PADDLE_TPU_SERVING_TRACE`` (on when unset).
    flight_ticks / flight_dir: the flight recorder keeps the last N tick
    records; on ``KVInvariantError`` (after a tick or a defrag) or any
    unhandled engine-loop exception a JSON postmortem (recent ticks,
    span window, metrics, scheduler/pool/prefix state, the violation
    list, the expected kernel libraries, the sentinel's report and, when
    lock tracing is on, the lock report) is written under ``flight_dir``
    (default ``PADDLE_TPU_FLIGHT_DIR`` or ``<tmp>/paddle_tpu_flight``)
    and its path lands in ``postmortem_path``. The document's keys and
    schema are the JAX engine's.
    recompile_sentinel: watch kernel library loads at runtime
    (observability/sentinel.py): after ``arm_sentinel()`` declares
    warmup done, any first load of a kernel library in the process
    raises a named ``RecompileWarning``, increments the labeled
    ``recompiles`` counter and records a sentinel span. Default from
    ``PADDLE_TPU_SERVING_SENTINEL`` (on when unset). Where the JAX
    sentinel watches XLA compiles, the port's event is the library load
    (the port compiles nothing per shape), and ``program_inventory`` is
    the sorted list of kernel libraries the model and quantization reach
    (``SERVING_KERNELS`` of the model module, plus ``int8_matmul`` for
    int8 weights).

    Migration blobs keep the JAX engine's keys, ``{fp, page_size,
    tokens, k, v}`` with ``k``/``v`` numpy arrays ``[L, Hkv, n_pages,
    ps, Dh]``, with one divergence: numpy has no bfloat16, so a bf16
    pool exports its bit patterns as ``np.uint16`` (the JAX engine
    exports an ml_dtypes bfloat16 array). Adopt takes float32 into an
    f32 pool and any 2-byte array (uint16, int16 or bfloat16) into a
    bf16 pool; any other pairing raises ValueError, as a page-size
    mismatch does, before anything is allocated.
    """

    # Sanctioned lock-free READS (analysis/concurrency.py guarded-by
    # pass; writes still flag). These engine-private objects are
    # mutated only on the worker tick thread under the tick lock;
    # cross-thread readers either call internally-synchronized
    # methods or take the tick lock themselves right after the
    # None/flag check, and tolerate one-tick staleness.
    _CC_LOCK_FREE_READS = {
        "scheduler": "queue methods serialize on Scheduler._lock; "
                     "slot/table state is read only under the tick "
                     "lock or after worker join",
        "prefix_cache": "is-enabled None-check only; every trie "
                        "touch below it runs under the tick lock",
        "tracer": "SpanTracer serializes on its own internal lock",
        "_closing": "handshake flag written under the _cond mutex; "
                    "the tick loop re-reads it each iteration "
                    "(worst case: one extra idle tick)",
    }
    # Caller-must-hold contracts the entry-point detector cannot see.
    _CC_REQUIRES = {
        "_spill_node": ["_tick_lock", "trie spill hook: PrefixCache "
                        "only evicts under the engine tick lock"],
    }

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
                 speculative=None, spec_k: int = 3,
                 check_invariants: Optional[bool] = None,
                 cold_tier_bytes: int = 0, on_chain_complete=None,
                 trace: Optional[bool] = None,
                 trace_capacity: int = 65536,
                 flight_ticks: int = 64,
                 flight_dir: Optional[str] = None,
                 recompile_sentinel: Optional[bool] = None):
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
        # the kernel libraries the ticks load on a CUDA device: the
        # sentinel's expected inventory and the postmortem's programs
        kernels = set(getattr(self._mod, "SERVING_KERNELS", ()))
        if is_quantized_params(params):
            kernels.add("int8_matmul")
        self.program_inventory = sorted(kernels)
        # ------------------------------------------- observability ----
        if trace is None:
            trace = _env_flag("PADDLE_TPU_SERVING_TRACE", True)
        self.tracer = SpanTracer(capacity=trace_capacity,
                                 enabled=bool(trace))
        self.flight = FlightRecorder(capacity=flight_ticks)
        self._flight_dir = flight_dir
        self.postmortem_path: Optional[str] = None
        if recompile_sentinel is None:
            recompile_sentinel = _env_flag("PADDLE_TPU_SERVING_SENTINEL",
                                           True)
        self.sentinel = RecompileSentinel(
            expected=self.program_inventory, tracer=self.tracer,
            metrics=self.metrics, label="serving-engine") \
            if recompile_sentinel else None
        self._tick_no = 0
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
        if check_invariants is None:
            check_invariants = _env_flag(
                "PADDLE_TPU_SERVING_CHECK_INVARIANTS", False)
        self._check_invariants = bool(check_invariants)

        # migration and the cold tier. In-flight chunked transfers, both
        # directions: exports pin their chain nodes (refs + 1 until
        # export_chain_end); adopts own freshly allocated pages that no
        # row or trie node references yet, plus pins on the matched warm
        # prefix. _audit_extras declares both to the audit.
        self.on_chain_complete = on_chain_complete
        self._exports: Dict[int, dict] = {}
        self._adopts: Dict[int, dict] = {}
        self._xfer_ids = itertools.count(1)
        self._cold = (ColdTier(int(cold_tier_bytes))
                      if int(cold_tier_bytes) > 0
                      and self.prefix_cache is not None else None)
        if self._cold is not None:
            self.prefix_cache.spill = self._spill_node

        # _cond stays a raw Condition (wait() releases its mutex, which a
        # traced wrapper would not see); the tick lock goes through
        # wrap_lock, so the lock tracer and fuzzer see every acquisition
        self._cond = threading.Condition()
        self._tick_lock = wrap_lock(threading.Lock(),
                                    "ServingEngine._tick_lock")
        self._closing = False
        self._drain = True
        # hand-back drain (a fleet's drain): admission stops and the
        # queued requests go back to the caller of close()
        self._hand_back = False
        self._returned: list = []
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

    @property
    def alive(self) -> bool:
        """The worker thread runs and no death is recorded."""
        return self._dead is None and self._worker.is_alive()

    def inject(self, req: Request) -> bool:
        """Enqueue an EXISTING :class:`Request` (a router's dispatch or
        re-dispatch): the admission checks of :meth:`submit`, but False
        instead of a raise, and nothing finalized, when this engine
        cannot take it (closed or closing, dead worker, queue full, a
        budget that never fits). The request keeps its own stream, so
        the caller's handle works across engines. Counters: ``submitted``
        counts accepted injections only; a refusal counts ``rejected``
        here."""
        if self._dead is not None:
            self.metrics.inc("rejected")
            return False
        with self._cond:
            if self._closing:
                self.metrics.inc("rejected")
                return False
            ok = self.scheduler.submit(req)
            if ok:
                self._cond.notify_all()
        if not ok:
            self.metrics.inc("rejected")
            return False
        if self._dead is not None and not req.done.is_set():
            # the worker died between the liveness check and the enqueue:
            # hand the request back only if it is still in the queue
            # untouched; otherwise the engine owns it and fails it
            if self.scheduler.drop_queued(lambda r: r is req):
                self.metrics.inc("rejected")
                return False
        self.metrics.inc("submitted")
        return True

    def close(self, drain: bool = True,
              hand_back: bool = False) -> "list[Request]":
        """Stop admission and shut down; returns the requests handed
        back (empty unless ``hand_back``). drain=True (default) finishes
        every queued + running request first; drain=False cancels them.
        ``hand_back=True`` stops admission at once, runs the in-flight
        slots (decoding or parked mid-prefill) to completion and returns
        the queued requests still QUEUED, unfinalized, for another
        engine. Each handed-back request is returned by one close()
        only."""
        if hand_back and not drain:
            raise ValueError("hand_back requires drain=True (a cancel "
                             "close finalizes, it cannot hand back)")
        with self._cond:
            if self._dead is not None and not self._worker.is_alive():
                if self.sentinel is not None:
                    self.sentinel.close()
                return self._take_returned()
            self._closing = True     # noqa: CC001(handshake flags are written under the _cond mutex; the tick loop re-reads them under the tick lock every iteration)
            self._drain = drain      # noqa: CC001(same _cond handshake as _closing above)
            self._hand_back = bool(hand_back)  # noqa: CC001(same _cond handshake as _closing above)
            self._cond.notify_all()
        self._worker.join()
        if self.sentinel is not None:
            self.sentinel.close()
        return self._take_returned()

    def _take_returned(self) -> "list[Request]":
        """Take the hand-back list (the worker has exited; the cond lock
        serializes racing closers)."""
        with self._cond:
            out, self._returned = self._returned, []  # noqa: CC001(worker has exited by the time any closer gets here; the _cond mutex serializes racing closers)
        return out

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
        if self._cold is not None:
            g["cold_tier"] = self._cold.stats()
        return g

    def snapshot(self) -> dict:
        """Plain-dict metrics snapshot plus live pool/queue gauges (read
        under the tick lock, so never a torn view of the scheduler)."""
        snap = self.metrics.snapshot()
        with self._tick_lock:
            snap["gauges"] = self._gauges()
        return snap

    def stats(self) -> dict:
        """Alias of :meth:`snapshot`."""
        return self.snapshot()

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

    def affinity_summary(self, max_depth: int = 2) -> dict:
        """``PrefixCache.affinity_summary`` read under the tick lock (any
        thread); ``{}`` when the prefix cache is off."""
        if self.prefix_cache is None:
            return {}
        with self._tick_lock:
            return self.prefix_cache.affinity_summary(max_depth)

    # ------------------------------------------------- KV-page migration ----
    def _check_page_size(self, page_size) -> None:
        if int(page_size) != int(self.pool.page_size):
            raise ValueError(
                f"page-size mismatch: exported {page_size}, this engine "
                f"serves {self.pool.page_size}")

    def _scatter(self, pages, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write host pages ``[L, Hkv, n, ps, Dh]`` into pool pages
        ``pages`` (tick lock held)."""
        idx = torch.tensor(list(pages), dtype=torch.long, device=self._dev)
        self._kp.index_copy_(2, idx, k.to(self._dev))
        self._vp.index_copy_(2, idx, v.to(self._dev))

    def export_chain(self, fp: int,
                     max_depth: int = 64) -> Optional[dict]:
        """A cached prefix chain's tokens and KV pages, named by its
        fingerprint (``prefix_fingerprints`` / ``affinity_summary``):
        ``{fp, page_size, tokens: [page token tuples], k, v}`` with
        ``k``/``v`` numpy ``[L, Hkv, n_pages, ps, Dh]`` (bf16 as uint16
        bits, see the class docstring), or None when no cached chain
        hashes to ``fp``. Runs under the tick lock, so no tick or defrag
        moves pages under the gather."""
        if self.prefix_cache is None:
            return None
        with self._tick_lock:
            nodes = self.prefix_cache.chain_by_fingerprint(fp, max_depth)
            if not nodes:
                return None
            pages = [nd.page for nd in nodes]
            tokens = [tuple(int(t) for t in nd.toks) for nd in nodes]
            k = _host_pages(self._kp, pages)
            v = _host_pages(self._vp, pages)
            host_sync("serving.migrate_export")
        return {"fp": int(fp), "page_size": int(self.pool.page_size),
                "tokens": tokens, "k": k, "v": v}

    def adopt_chain(self, blob: dict) -> dict:
        """Adopt an :meth:`export_chain` blob: allocate pages for the
        chain's uncached suffix (evicting refcount-0 pages under
        pressure, as admission does), scatter the KV into them and graft
        the nodes into the trie at refs 0. A later prompt sharing the
        prefix attaches it by exact token tuples and decodes bitwise as
        on the source. Returns ``{"matched_pages", "adopted_pages"}``;
        raises ValueError on a page-size, dtype or shape mismatch and
        RuntimeError when the suffix does not fit after eviction."""
        if self.prefix_cache is None:
            raise RuntimeError("adopt_chain needs prefix_cache=True")
        self._check_page_size(blob["page_size"])
        tokens = [tuple(int(t) for t in tt) for tt in blob["tokens"]]
        with self._tick_lock:
            # the pools are rebound by every tick: read them under the
            # lock (the checks raise before anything is allocated)
            k = _blob_tensor(blob["k"], self._kp, len(tokens))
            v = _blob_tensor(blob["v"], self._vp, len(tokens))
            pc = self.prefix_cache
            have = pc.match_chain(tokens)
            need = len(tokens) - have
            if need == 0:
                return {"matched_pages": have, "adopted_pages": 0}
            if not self.pool.can_alloc(need):
                pc.evict(need - self.pool.free_pages)
            if not self.pool.can_alloc(need):
                raise RuntimeError(
                    f"cannot adopt chain: {need} pages needed, "
                    f"{self.pool.free_pages} free after eviction")
            pages = self.pool.alloc(need)
            self._scatter(pages, k[:, :, have:], v[:, :, have:])
            pc.adopt_chain(tokens, pages, start=have)
        return {"matched_pages": have, "adopted_pages": need}

    # ------------------------------------- chunked (overlapped) transfer ----
    # The whole-blob path holds both engines' tick locks for the whole
    # gather or scatter. The chunked protocol holds a lock for one bounded
    # chunk at a time: begin pins under the lock, chunks stream between
    # ticks, and the trie graft happens only at commit (exactly once;
    # abort and end make a partial transfer invisible).

    def export_chain_begin(self, fp: int,
                           max_depth: int = 64) -> Optional[dict]:
        """Open a chunked export: resolve the chain of ``fp``, PIN its
        nodes (refs + 1: eviction cannot free them while the transfer
        streams) and return ``{"xid", "fp", "page_size", "tokens"}``, or
        None when nothing hashes to ``fp``. :meth:`export_chain_end`
        releases the pins."""
        if self.prefix_cache is None:
            return None
        with self._tick_lock:
            nodes = self.prefix_cache.chain_by_fingerprint(fp, max_depth)
            if not nodes:
                return None
            for nd in nodes:
                nd.refs += 1
            xid = next(self._xfer_ids)
            self._exports[xid] = {"nodes": nodes}
            tokens = [tuple(int(t) for t in nd.toks) for nd in nodes]
        return {"xid": xid, "fp": int(fp),
                "page_size": int(self.pool.page_size), "tokens": tokens}

    def export_chain_chunk(self, xid: int, start: int,
                           count: int) -> dict:
        """Pages ``[start, start + count)`` of an open export as
        ``{"start", "count", "k", "v"}``. Page ids are read from the
        nodes at gather time: pins stop pages being freed, not moved, so
        a defrag between chunks is harmless."""
        with self._tick_lock:
            nodes = self._exports[xid]["nodes"][start:start + count]
            pages = [nd.page for nd in nodes]
            k = _host_pages(self._kp, pages)
            v = _host_pages(self._vp, pages)
            host_sync("serving.migrate_export")
        return {"start": int(start), "count": len(nodes), "k": k, "v": v}

    def export_chain_end(self, xid: int) -> None:
        """Close a chunked export and release its pins. Idempotent: an
        unknown or closed ``xid`` is a no-op."""
        with self._tick_lock:
            ent = self._exports.pop(xid, None)
            if ent is None:
                return
            for nd in ent["nodes"]:
                nd.refs -= 1

    def adopt_chain_begin(self, header: dict) -> dict:
        """Open a chunked adopt from an :meth:`export_chain_begin`
        header: match the warm prefix and PIN it, allocate pages for the
        uncached suffix (evicting under pressure) and return ``{"aid",
        "matched_pages", "need"}``; ``aid`` is None (nothing held) when
        the whole chain is cached. The pages belong to the transfer
        until :meth:`adopt_chain_commit`; :meth:`adopt_chain_abort` frees
        them. Raises ValueError on a page-size mismatch, RuntimeError
        when the suffix does not fit."""
        if self.prefix_cache is None:
            raise RuntimeError("adopt_chain needs prefix_cache=True")
        self._check_page_size(header["page_size"])
        tokens = [tuple(int(t) for t in tt) for tt in header["tokens"]]
        with self._tick_lock:
            pc = self.prefix_cache
            pinned = pc.chain_nodes(tokens)
            have = len(pinned)
            need = len(tokens) - have
            if need == 0:
                return {"aid": None, "matched_pages": have, "need": 0}
            if not self.pool.can_alloc(need):
                pc.evict(need - self.pool.free_pages)
            if not self.pool.can_alloc(need):
                raise RuntimeError(
                    f"cannot adopt chain: {need} pages needed, "
                    f"{self.pool.free_pages} free after eviction")
            for nd in pinned:
                nd.refs += 1
            pages = self.pool.alloc(need)
            aid = next(self._xfer_ids)
            self._adopts[aid] = {"tokens": tokens, "have": have,
                                 "pages": pages, "pinned": pinned,
                                 "filled": 0}
        return {"aid": aid, "matched_pages": have, "need": need}

    def adopt_chain_chunk(self, aid: int, start: int, k, v) -> None:
        """Scatter one exported chunk (chain page index ``start``, arrays
        from :meth:`export_chain_chunk`) into the transfer's pages.
        Chunks may arrive in any order; commit checks completeness."""
        count = int(np.shape(k)[2])
        with self._tick_lock:
            kt = _blob_tensor(k, self._kp, count)
            vt = _blob_tensor(v, self._vp, count)
            ent = self._adopts[aid]
            off = int(start) - ent["have"]
            if off < 0 or off + count > len(ent["pages"]):
                raise ValueError(
                    f"chunk pages {start}..{int(start) + count} outside "
                    f"the adopted suffix {ent['have']}.."
                    f"{ent['have'] + len(ent['pages'])}")
            self._scatter(ent["pages"][off:off + count], kt, vt)
            ent["filled"] += count

    def adopt_chain_commit(self, aid: int) -> dict:
        """Finish a chunked adopt: check every suffix page arrived,
        match the warm prefix again (a local prefill may have cached the
        same leading pages meanwhile: those are freed, not grafted),
        graft the rest at refs 0 and release the pins. Returns
        ``{"matched_pages", "adopted_pages"}``."""
        with self._tick_lock:
            ent = self._adopts.pop(aid)
            pc = self.prefix_cache
            dup = 0
            try:
                need = len(ent["tokens"]) - ent["have"]
                if ent["filled"] != need:
                    raise RuntimeError(
                        f"adopt_chain_commit: {ent['filled']} of "
                        f"{need} suffix pages arrived")
                now_have = pc.match_chain(ent["tokens"])
                dup = max(0, now_have - ent["have"])
                if dup > 0:
                    self.pool.free(ent["pages"][:dup])
                pc.adopt_chain(ent["tokens"], ent["pages"][dup:],
                               start=now_have)
            except BaseException:
                self.pool.free(ent["pages"][dup:])
                raise
            finally:
                for nd in ent["pinned"]:
                    nd.refs -= 1
        return {"matched_pages": ent["have"],
                "adopted_pages": len(ent["pages"]) - dup}

    def adopt_chain_abort(self, aid: int) -> None:
        """Abandon a chunked adopt: free its pages, release its pins.
        Idempotent on an unknown ``aid``."""
        with self._tick_lock:
            ent = self._adopts.pop(aid, None)
            if ent is None:
                return
            self.pool.free(ent["pages"])
            for nd in ent["pinned"]:
                nd.refs -= 1

    def _audit_extras(self):
        """``(extra_refs, extra_pages)`` of the in-flight chunked
        transfers for ``audit_serving_state``: export and adopt pins as
        per-node refcount credits, adopt-owned pages as owned. Tick lock
        held."""
        extra_refs: Dict[int, int] = {}
        extra_pages: Dict[int, str] = {}
        for ent in self._exports.values():
            for nd in ent["nodes"]:
                extra_refs[id(nd)] = extra_refs.get(id(nd), 0) + 1
        for aid, ent in self._adopts.items():
            for nd in ent["pinned"]:
                extra_refs[id(nd)] = extra_refs.get(id(nd), 0) + 1
            for p in ent["pages"]:
                extra_pages[int(p)] = f"adopt-{aid}"
        return extra_refs, extra_pages

    # -------------------------------------------- host-memory cold tier ----
    def _spill_node(self, nd) -> None:
        """``PrefixCache.spill`` hook: copy one evicted node's page to
        the cold tier before the page is freed. Runs inside
        ``PrefixCache.evict`` (tick lock held), which swallows a
        failure: eviction must always succeed."""
        if self._cold is None:
            return
        fp = self.prefix_cache.node_fingerprint(nd)
        k = _gather(self._kp, [nd.page])
        v = _gather(self._vp, [nd.page])
        host_sync("serving.cold_spill")
        if self._cold.put(fp, nd.toks, k, v):
            self.metrics.inc("cold_spills")

    def _rewarm_cold(self, reqs) -> None:
        """Before admission (engine loop, tick lock held): for each of
        ``reqs`` (the first queued requests) whose warm trie match ends
        where a spilled chain begins, re-adopt the contiguous cold run
        (alloc, scatter, graft), so admission attaches it as a warm hit.
        Each page's token tuple is compared with the prompt first (the
        fingerprint only indexes). Best-effort: a failure skips the
        request, never the loop."""
        pc = self.prefix_cache
        ps = self.pool.page_size
        for req in reqs:
            try:
                max_pages = (int(req.prompt.size) - 1) // ps
                if max_pages <= 0:
                    continue
                tuples = [tuple(int(t) for t in
                                req.prompt[i * ps:(i + 1) * ps])
                          for i in range(max_pages)]
                warm = pc.match_chain(tuples)
                fp, fps = 0, []
                for tt in tuples:
                    fp = _fp_extend(fp, tt)
                    fps.append(fp)
                run = []
                for i in range(warm, max_pages):
                    ent = self._cold.get(fps[i])
                    if ent is None or ent["toks"] != tuples[i]:
                        break       # a collision or a gap ends the run
                    run.append(ent)
                if not run:
                    continue
                t0 = time.monotonic()
                n = len(run)
                if not self.pool.can_alloc(n):
                    # evict with the warm prefix PINNED: its leaf may be
                    # refcount 0 and childless, and the graft walks it
                    pinned = pc.chain_nodes(tuples[:warm])
                    for nd in pinned:
                        nd.refs += 1
                    try:
                        pc.evict(n - self.pool.free_pages)
                    finally:
                        for nd in pinned:
                            nd.refs -= 1
                if not self.pool.can_alloc(n):
                    continue        # no room: leave it cold
                pages = self.pool.alloc(n)
                self._scatter(pages, torch.cat([e["k"] for e in run], 2),
                              torch.cat([e["v"] for e in run], 2))
                pc.adopt_chain(tuples[:warm + n], pages, start=warm)
                for i in range(warm, warm + n):
                    self._cold.pop(fps[i])
                self.metrics.inc("cold_hits")
                self.metrics.inc("cold_hit_pages", n)
                self.metrics.observe("cold_adopt_s",
                                     time.monotonic() - t0)
            except Exception:
                continue    # the rewarm is opportunistic, never fatal

    # ------------------------------------------------------------- audit ----
    def _audit_state(self):
        """The violation list of the current state (tick lock held)."""
        extra_refs, extra_pages = self._audit_extras()
        return audit_serving_state(
            self.pool, self.scheduler, self.prefix_cache,
            prefill_queue=tuple(self._prefill_q),
            extra_refs=extra_refs, extra_pages=extra_pages)

    def audit(self):
        """Paged-KV invariant audit, serialized against ticks: the
        violation list, empty when healthy."""
        with self._tick_lock:
            return self._audit_state()

    def _geometry_desc(self) -> str:
        """One line of engine geometry, named by every violation report."""
        return (f"engine geometry: page_size={self.pool.page_size} "
                f"pages_per_slot={self.scheduler.pages_per_slot} "
                f"max_batch={self.scheduler.max_batch} "
                f"total_pages={self.pool.total_pages} "
                f"max_prompt_len={self.scheduler.max_prompt_len} "
                f"prefill_budget={self._budget} "
                f"decode_block={self._decode_block} "
                f"spec_k={self._spec_k}")

    def _audit_or_raise(self) -> None:
        """Per-tick check (tick lock held)."""
        with self.tracer.span("serving.audit", track="engine.audit"):
            violations = self._audit_state()
        if violations:
            self.metrics.inc("invariant_violations", len(violations))
            raise KVInvariantError(violations,
                                   context=self._geometry_desc())

    def defragment(self) -> int:
        """Compact the live pages to the pool's low indices: rewrites the
        pools and every slot's table row (``apply_defrag``), the
        requests' page lists and parked requests' stashed rows
        (``Scheduler.remap_pages``), the prefix cache's pages
        (``PrefixCache.remap``) and the pages of pending chunked adopts,
        then commits the plan to the allocator. Returns the number of
        pages moved. Safe mid-generation and mid-transfer: it runs under
        the tick lock, between ticks. With ``check_invariants`` the plan
        is audited before anything is rewritten (it must cover every
        live reference) and the state after it; a violation raises
        ``KVInvariantError``; a violation in the state after it also
        writes the postmortem."""
        with self._tick_lock, \
                self.tracer.span("serving.defrag", track="engine.defrag"):
            plan = self.pool.defrag_plan()
            if not plan:
                return 0
            if self._check_invariants:
                bad = audit_defrag_plan(plan, self.pool, self.scheduler,
                                        self.prefix_cache)
                if bad:
                    raise KVInvariantError(bad,
                                           context=self._geometry_desc())
            self._kp, self._vp, tables = apply_defrag(
                plan, self._kp, self._vp, self.scheduler.tables)
            self.scheduler.tables = np.array(tables.numpy(), np.int32)
            self.scheduler.remap_pages(plan)
            if self.prefix_cache is not None:
                self.prefix_cache.remap(plan)
            # pending adopts' pages are allocated (the plan moves them)
            # but live only in the transfer entries
            for ent in self._adopts.values():
                ent["pages"] = [plan.get(p, p) for p in ent["pages"]]
            self.pool.commit_defrag(plan)
            if self._check_invariants:
                try:
                    self._audit_or_raise()
                except BaseException as e:
                    # the caller gets the raise, the postmortem the state
                    try:
                        self._write_postmortem(e)
                    except Exception:
                        pass    # a failing dump must not hide the error
                    raise
            return len(plan)

    # ----------------------------------------------------- observability ----
    def export_trace(self, path: str) -> str:
        """Write the span tracer's ring as Perfetto-loadable Chrome-trace
        JSON (one track per engine phase and per slot); returns
        ``path``."""
        return self.tracer.export(path)

    def arm_sentinel(self) -> None:
        """Declare warmup complete: from now on a first load of a kernel
        library in this process raises ``RecompileWarning`` and
        increments the labeled ``recompiles`` counter (no-op when the
        sentinel is off). Call after :meth:`warm_programs`."""
        if self.sentinel is not None:
            self.sentinel.arm()

    def warm_programs(self) -> int:
        """Run one all-padding tick on each tick path this engine has —
        the fused block, and the verify tick of a speculative engine or
        else the ragged tick with and without the fused decode tail — so
        every kernel library of ``program_inventory`` is loaded before
        the sentinel is armed. Every packed token is the padding slot
        and every KV write lands on the trash page; the outputs are
        discarded. Safe any time (serialized against ticks); counts no
        metric. Returns the number of ticks run."""
        S = self.scheduler.max_batch
        ps = self.pool.page_size
        n = 0
        with self._tick_lock:
            tabs = np.full((S, self.scheduler.pages_per_slot),
                           PagePool.TRASH, np.int32)
            zs = np.zeros((S,), np.int32)
            tail_live = self._to_dev(np.zeros((S,), bool))
            if self._spec_k:
                tok, meta = llama.pack_tick([], [], tabs, ps, self._dev,
                                            spec_k=self._spec_k)
                meta["tail_live"] = tail_live
                _, _, _, self._kp, self._vp = self._mod.serving_tick(
                    self._params, tok, meta, self._kp, self._vp, self._cfg,
                    spec_k=self._spec_k)
                n += 1
            else:
                for tail in sorted({self._decode_block - 1, 0},
                                   reverse=True):
                    tok, meta = llama.pack_tick([], [], tabs, ps, self._dev)
                    meta["tail_live"] = tail_live
                    _, _, self._kp, self._vp = self._mod.serving_tick(
                        self._params, tok, meta, self._kp, self._vp,
                        self._cfg, decode_tail=tail)
                    n += 1
            _, self._kp, self._vp = self._mod.serving_tick_block(
                self._params, self._to_dev(zs), self._to_dev(zs),
                self._to_dev(tabs), self._kp, self._vp, self._cfg,
                num_steps=self._decode_block)
            n += 1
        return n

    def _record_tick(self, t0: float, t1: float, live, spans,
                     admitted: int) -> None:
        """Per-tick evidence (tick lock held): slot-track spans for each
        live decoder and prefill span, and one flight-recorder record of
        the tick's geometry and the live pool/queue gauges. Requests may
        have retired inside the tick: only ids are used."""
        tick = self._tick_no
        self._tick_no += 1
        if self.tracer.enabled:
            for slot, req in live:
                self.tracer.add("decode", f"slot{slot}", t0, t1,
                                req=req.id, tick=tick)
            for slot, req, start, take in spans:
                self.tracer.add("prefill.chunk", f"slot{slot}", t0, t1,
                                req=req.id, tick=tick, start=int(start),
                                tokens=int(take))
        self.flight.record_tick(
            tick=tick, t_mono_s=round(t0, 6), dur_s=round(t1 - t0, 6),
            live=len(live), prefill_spans=len(spans),
            span_tokens=int(sum(t for _, _, _, t in spans)),
            admitted=int(admitted), queued=self.scheduler.queued(),
            occupancy=self.scheduler.occupancy,
            free_pages=self.pool.free_pages,
            prefill_queue_depth=len(self._prefill_q))

    def _write_postmortem(self, e: BaseException) -> str:
        """Dump the flight-recorder postmortem (tick lock held): the
        error (with the violation list when a ``KVInvariantError`` is the
        killer), the engine geometry and its kernel libraries, the last
        tick records, the span window, a metrics snapshot, the sentinel's
        report and the scheduler/pool/prefix state at death. Returns the
        path written (also kept in ``postmortem_path``)."""
        slots = []
        for slot, req in enumerate(self.scheduler.slots):
            if req is None:
                continue
            slots.append({
                "slot": slot, "req": req.id, "state": req.state,
                "length": int(self.scheduler.lengths[slot]),
                "prefilling": bool(req.prefilling),
                "chunk_done": int(req.chunk_done),
                "cached_len": int(req.cached_len),
                "private_pages": len(req.pages),
                "prefix_pages": len(req.prefix_nodes),
                "row": self.scheduler.effective_row(slot).tolist(),
            })
        state = {
            "slots": slots,
            "queued": self.scheduler.queued(),
            "prefill_queue": [req.id for _, req in self._prefill_q],
            "pool": {"total_pages": self.pool.total_pages,
                     "page_size": self.pool.page_size,
                     "free_pages": self.pool.free_pages},
        }
        if self.prefix_cache is not None:
            state["prefix_cache"] = self.prefix_cache.stats()
        lt = get_tracer()
        if lt is not None:
            # the acquisition graph and wait/hold aggregates: which lock
            # the dying engine was living under
            state["lock_trace"] = lt.report()
        spans = [sp.to_dict() for sp in self.tracer.spans()] \
            if self.tracer.enabled else None
        self.postmortem_path = self.flight.dump(
            dir=self._flight_dir, error=e,
            geometry=self._geometry_desc(),
            programs=self.program_inventory, state=state, spans=spans,
            metrics=self.metrics.snapshot(),
            sentinel=(self.sentinel.report()
                      if self.sentinel is not None else None))
        return self.postmortem_path

    # ------------------------------------------------------------ tokens ----
    def _emit(self, slot: int, req: Request, tok: int) -> bool:
        """Stream one token; True when the request just finished (EOS or
        max_new_tokens)."""
        now = time.monotonic()
        if req.first_token_t is None:
            req.first_token_t = now
            self.metrics.observe("ttft_s", now - req.submit_t)
            # on the metric's own stamps: the span equals the observation
            self.tracer.add("ttft", f"slot{slot}", req.submit_t, now,
                            req=req.id)
        req.tokens.append(tok)
        req.stream.put(tok)
        self._produced[slot] += 1
        self.metrics.inc("tokens_out")
        return bool(self._produced[slot] >= req.max_new_tokens
                    or (req.eos_token_id is not None
                        and tok == req.eos_token_id))

    def _retire(self, slot: int, state: str) -> None:
        req = self.scheduler.retire(slot, state)
        self._cur_tok[slot] = 0
        self._produced[slot] = 0
        self._key_data[slot] = 0
        self._samp_cache = None
        self.metrics.inc({COMPLETED: "completed", CANCELLED: "cancelled",
                          TIMED_OUT: "timed_out"}[state])
        # the whole lifecycle, submit -> retirement, on the slot track
        self.tracer.add("request", f"slot{slot}", req.submit_t,
                        req.finish_t, req=req.id, state=state,
                        tokens=len(req.tokens))

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
            # chain-completion event: the per-page fingerprints of the
            # PROMPT (dedup can make req.prefix_nodes skip chain nodes)
            n_pages = n // self.pool.page_size
            if self.on_chain_complete is not None and n_pages > 0:
                ps = self.pool.page_size
                fp, fps = 0, []
                for i in range(n_pages):
                    fp = _fp_extend(fp, req.prompt[i * ps:(i + 1) * ps])
                    fps.append(fp)
                try:
                    self.on_chain_complete(req, {
                        "fp": fps[-1], "fps": fps, "pages": n_pages,
                        "prompt_tokens": int(n)})
                except Exception:
                    pass    # a policy's failure must not kill the tick
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
        t0 = time.monotonic()
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
        if drafts and self.tracer.enabled:
            self.tracer.add(
                "serving.draft", "engine.draft", t0, time.monotonic(),
                slots=len(drafts),
                tokens=int(sum(d.size for d in drafts.values())))
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
        span_tok = (sum(take for _, _, _, take in spans)
                    + sum(1 + d.size for d in drafts.values()))
        t0 = time.perf_counter()
        m0 = time.monotonic()
        with RecordEvent("serving.tick"), \
                self.tracer.span("serving.tick", track="engine.decode",
                                 tick=self._tick_no, width=int(span_tok),
                                 live=len(live), span_tokens=int(span_tok),
                                 tail=int(tail), spec=len(drafts)):
            if spec:
                toks, accept, _, self._kp, self._vp = \
                    self._mod.serving_tick(
                        self._params, tok, meta, self._kp, self._vp,
                        self._cfg, spec_k=spec)
                # the tick's read-back: tokens [S, 1 + spec_k] and accept
                accept = accept.cpu().numpy()
                toks = toks.cpu().numpy()
                host_sync("serving.tick.readback")
            else:
                toks, _, self._kp, self._vp = self._mod.serving_tick(
                    self._params, tok, meta, self._kp, self._vp, self._cfg,
                    decode_tail=tail)
                toks = toks.cpu().numpy()   # the one host read-back
                host_sync("serving.tick.readback")
        m1 = time.monotonic()
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
                if self.tracer.enabled:
                    self.tracer.add("spec.verify", f"slot{slot}", m0, m1,
                                    req=req.id, drafted=k_s, accepted=a)
                    if k_s > a:
                        self.tracer.add("spec.rollback", f"slot{slot}",
                                        m1, m1, req=req.id,
                                        rejected=k_s - a)
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
        with RecordEvent("serving.decode_step"), \
                self.tracer.span("serving.tick", track="engine.decode",
                                 tick=self._tick_no, kind="block",
                                 live=len(live), steps=k):
            toks, self._kp, self._vp = self._mod.serving_tick_block(
                self._params, self._to_dev(self._cur_tok),
                self._to_dev(self.scheduler.lengths),
                self._to_dev(self.scheduler.tables), self._kp, self._vp,
                self._cfg, num_steps=k, sampling=self._sampling_arrays())
            toks = toks.cpu().numpy()   # the block's read-back [S, k]
            host_sync("serving.tick.readback")
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
            try:
                # the postmortem snapshots the state BEFORE _fail_all
                # retires everything, under the tick lock (a caller in
                # defragment() must not rewrite it while the dump walks it)
                with self._tick_lock:
                    self._write_postmortem(e)
            except Exception:
                pass        # a failing dump must not hide the error
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
                    # so the pool ends balanced. Teardown is disposal, not
                    # pressure: nothing spills to the cold tier.
                    self.prefix_cache.spill = None
                    self.prefix_cache.evict(self.prefix_cache.cached_pages)

    def _run(self) -> None:
        while True:
            # FLAGS_check_nan_inf is process-wide, the checker per thread
            debugging.sync_thread()
            with self._tick_lock:
                now = time.monotonic()
                self._sweep(now)
                if self._closing and not self._drain:
                    break
                if self._closing and self._hand_back:
                    # hand-back drain: admission stops now; the queued
                    # requests go back unfinalized, the slots run out
                    handed = self.scheduler.drop_queued(lambda r: True)
                    if handed:
                        self._returned.extend(handed)
                        self.metrics.inc("handed_back", len(handed))
                frontier = None
                if self._cold is not None and len(self._cold):
                    # rewarm BEFORE admission, so it sees a warm hit; and
                    # admit only the requests queued at this look: one
                    # submitted after it waits a loop turn instead of
                    # being admitted without its rewarm
                    frontier = self.scheduler.peek_queued(
                        self.scheduler.max_batch
                        + self.scheduler.admission_window)
                    if frontier:
                        self._rewarm_cold(frontier[:4])
                t_adm = time.monotonic()
                with RecordEvent("serving.admit"):
                    admitted = self.scheduler.admit(only=frontier)
                if admitted:
                    # only when work happened: an idle engine polls
                    # admission every 50 ms and must not flush real spans
                    # out of the ring
                    self.tracer.add("serving.admission", "engine.admission",
                                    t_adm, time.monotonic(),
                                    admitted=len(admitted))
                for slot, req in admitted:
                    self.metrics.inc("admitted")
                    self.metrics.observe("queue_wait_s",
                                         req.admit_t - req.submit_t)
                    # on the request's own stamps (== the observation)
                    self.tracer.add("queue", f"slot{slot}", req.submit_t,
                                    req.admit_t, req=req.id,
                                    prompt=int(req.prompt.size),
                                    cached=int(req.cached_len))
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
                    t_tick0 = time.monotonic()
                    self._decode_tick(live, spans)
                    t_tick1 = time.monotonic()
                    self.metrics.inc("ticks")
                    self._last_decode_t = (time.perf_counter()
                                           if live else None)
                    self._record_tick(t_tick0, t_tick1, live, spans,
                                      len(admitted))
                    if self._check_invariants:
                        self._audit_or_raise()
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
