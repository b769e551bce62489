"""Worker process entrypoint: one ServingEngine per process.

Port of ``paddle_tpu/serving/fleet/proc/worker.py``. Spawn-safe by
construction: this module imports ONLY stdlib + wire at module scope,
and :func:`worker_main` exports ``spec.env`` FIRST — so the env (thread
counts, a ``CUDA_VISIBLE_DEVICES`` assignment) is in place before the
worker touches CUDA. Each worker then owns a full PyTorch runtime: its
own CUDA context and caching allocator, its own kernel libraries
(``ops/kernels/_build.load`` of the built ``build/kernels/``), its own
page pool and its own engine worker thread — the GIL stops at the
process boundary, which is the whole point of fleet/proc/ over the
in-process fleet.

Weights are NOT shipped: every worker re-derives them from a
``torch.Generator`` seeded with ``spec.params_seed`` on its device
(``init_params``), so all replicas are bitwise-identical decoders
(re-dispatch safety) and the spec stays a few hundred bytes. On the
card that is exactly the draw of a parent that calls ``init_params``
with ``torch.Generator(device="cuda").manual_seed(seed)``.

Streaming: one relay thread per accepted request iterates the local
RequestHandle and forwards each token as a ``tok`` frame (fseq
0,1,2,...) followed by ONE terminal ``done`` frame — except for
requests the shutdown hand-back returns still QUEUED, which get no
terminal frame (the parent re-dispatches them; their relay threads are
daemons parked on an un-ended stream and die with the process).

Every rpc reply goes through ``wire.check_plain``: a reply holding a
``torch.Tensor`` is answered as a failed rpc instead of crossing the
queue by handle.
"""
from __future__ import annotations

import os
import threading
import time
import traceback

from .wire import check_plain, request_from_wire

__all__ = ["worker_main"]


def _build_engine(spec):
    """Env is already exported; now it is safe to pull in torch and
    CUDA. Returns ``(engine, device, init_s)``, ``init_s`` the seconds
    the weights took. ``spec.device`` None means the card: without CUDA
    this raises (``resolve_device``), it never falls back to the CPU."""
    import torch

    from ....device import resolve_device
    from ....models import llama as L
    from ...engine import ServingEngine

    dev = resolve_device(spec.device)
    cfg_kw = dict(spec.cfg_kw)
    dt = cfg_kw.get("dtype")
    if isinstance(dt, str):
        cfg_kw["dtype"] = L._TORCH_DTYPES[dt]
    cfg = L.LlamaConfig(**cfg_kw)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(int(spec.params_seed))
    params = L.init_params(cfg, gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    return (ServingEngine(params, cfg, device=dev, **spec.engine_kw), dev,
            init_s)


def _serving_counters() -> dict:
    """The launch counters of the kernels a serving tick can reach."""
    from ....ops.kernels import int8_matmul as im
    from ....ops.kernels import ragged_paged_attention as rpa
    return {"ragged_paged_attention": rpa.ragged_paged_attention_packed,
            "int8_matmul": im.int8_matmul}


def _launches(zero: bool) -> dict:
    """This process's kernel launch counts; ``zero`` sets them to 0
    after reading (the counters are process-wide, so a parent reads a
    worker's through this op)."""
    fns = _serving_counters()
    out = {n: int(fn.launches) for n, fn in fns.items()}
    if zero:
        for fn in fns.values():
            fn.launches = 0
    return out


def worker_main(spec, cmd_q, evt_q) -> None:
    """Process target: build the engine, announce readiness, serve the
    command queue until ``stop`` / shutdown."""
    main_at = time.time()   # wall clock: the parent times the spawn
    os.environ.update({str(k): str(v) for k, v in spec.env.items()})
    try:
        _run(spec, cmd_q, evt_q, main_at)
    except BaseException:
        try:
            evt_q.put(("fatal", traceback.format_exc()))
        except Exception:
            pass
        raise


def _run(spec, cmd_q, evt_q, main_at: float = 0.0) -> None:
    from ...scheduler import RequestHandle

    t0 = time.perf_counter()
    eng, dev, init_s = _build_engine(spec)
    t1 = time.perf_counter()
    if spec.warm:
        eng.warm_programs()
    # bring-up times: ``main_at`` is the wall clock at worker_main's
    # entry (after the spawn and the imports of unpickling its target)
    startup = {"main_at": main_at, "init_s": init_s,
               "build_s": t1 - t0, "warm_s": time.perf_counter() - t1}
    evt_q.put(("ready", {"page_size": int(eng.pool.page_size),
                         "max_batch": int(eng.scheduler.max_batch),
                         "pid": os.getpid(), "device": str(dev),
                         "startup": startup}))

    local: dict = {}        # parent rid -> local Request
    relays: dict = {}       # parent rid -> relay thread
    rids: dict = {}         # id(local Request) -> parent rid
    reg = threading.Lock()

    # chain-completion events (router-driven migration): the engine
    # hook fires under the worker's tick lock, so it only ENQUEUES —
    # the parent's pump thread delivers it to the fleet policy. The
    # payload carries the PARENT rid (what the router knows requests
    # by), not the worker-local one.
    def on_chain_complete(req, info) -> None:
        with reg:
            rid = rids.get(id(req))
        if rid is None:
            return      # not an injected request (shouldn't happen)
        evt_q.put(("evt", "chain_complete", dict(info, rid=rid)))

    eng.on_chain_complete = on_chain_complete

    def relay(rid: int, req) -> None:
        fseq = 0
        for tok in RequestHandle(req):
            evt_q.put(("tok", rid, fseq, int(tok)))
            fseq += 1
        err = "" if req.error is None \
            else f"{type(req.error).__name__}: {req.error}"
        evt_q.put(("done", rid, fseq, req.state, err))

    def op_inject(payload):
        req = request_from_wire(payload)
        rid = int(payload["rid"])
        # register the rid mapping BEFORE inject: the engine loop may
        # prefill and fire the chain-complete hook before inject even
        # returns, and the event must carry the parent rid
        with reg:
            rids[id(req)] = rid
        if not eng.inject(req):
            with reg:
                rids.pop(id(req), None)
            return {"accepted": False}
        th = threading.Thread(target=relay, args=(rid, req),
                              daemon=True, name=f"relay-{rid}")
        with reg:
            local[rid] = req
            relays[rid] = th
        th.start()
        return {"accepted": True}

    def op_shutdown(payload):
        handed = eng.close(drain=bool(payload.get("drain", True)),
                           hand_back=bool(payload.get("hand_back",
                                                      True)))
        handed_ids = {id(r) for r in handed}
        with reg:
            handed_rids = [rid for rid, r in local.items()
                           if id(r) in handed_ids]
            pending = [(rid, th) for rid, th in relays.items()
                       if id(local[rid]) not in handed_ids]
        # every non-handed request has finished inside close(); join
        # the relays so their done frames are ON the event queue before
        # the shutdown reply (queue FIFO then guarantees the parent
        # sees every terminal frame before it processes the reply)
        for _, th in pending:
            th.join(timeout=10.0)
        try:
            snap = eng.snapshot()
        except Exception:
            snap = None
        sent = eng.sentinel.report() if eng.sentinel is not None \
            else None
        return {"handed": handed_rids, "snapshot": snap,
                "sentinel": sent}

    ops = {
        "ping": lambda p: {"pid": os.getpid()},
        "inject": op_inject,
        "gauges": lambda p: eng.gauges(),
        "health": lambda p: {"alive": eng.alive,
                             "gauges": eng.gauges()},
        "affinity": lambda p: eng.affinity_summary(
            int(p.get("max_depth", 2))),
        "expose": lambda p: eng.expose(),
        "snapshot": lambda p: eng.snapshot(),
        "arm_sentinel": lambda p: (eng.arm_sentinel(), {})[1],
        "sentinel_report": lambda p: (
            eng.sentinel.report() if eng.sentinel is not None
            else None),
        "warm_programs": lambda p: {"compiled": eng.warm_programs()},
        "defragment": lambda p: {"moved": eng.defragment()},
        "export_chain": lambda p: eng.export_chain(
            int(p["fp"]), int(p.get("max_depth", 64))),
        "adopt_chain": lambda p: eng.adopt_chain(p["blob"]),
        # chunked (decode-overlapped) migration protocol: each op holds
        # the worker's tick lock only for its one bounded step, so the
        # tick loops on BOTH sides keep streaming while pages cross
        "export_chain_begin": lambda p: eng.export_chain_begin(
            int(p["fp"]), int(p.get("max_depth", 64))),
        "export_chain_chunk": lambda p: eng.export_chain_chunk(
            int(p["xid"]), int(p["start"]), int(p["count"])),
        "export_chain_end": lambda p: (
            eng.export_chain_end(int(p["xid"])), {})[1],
        "adopt_chain_begin": lambda p: eng.adopt_chain_begin(
            p["header"]),
        "adopt_chain_chunk": lambda p: (eng.adopt_chain_chunk(
            int(p["aid"]), int(p["start"]), p["k"], p["v"]), {})[1],
        "adopt_chain_commit": lambda p: eng.adopt_chain_commit(
            int(p["aid"])),
        "adopt_chain_abort": lambda p: (
            eng.adopt_chain_abort(int(p["aid"])), {})[1],
        # flight-recorder tick records (t_mono_s/dur_s per tick): the
        # parent computes per-tick stall = inter-tick gaps from these —
        # how migration overlap is MEASURED rather than asserted
        "flight": lambda p: {"ticks": eng.flight.ticks()},
        # the serving kernels' launch counters of THIS process (the
        # port's kernel wrappers count their launches; a parent reads
        # and zeroes a worker's here)
        "launches": lambda p: _launches(bool(p.get("zero", False))),
        "shutdown": op_shutdown,
    }

    while True:
        msg = cmd_q.get()
        kind = msg[0]
        if kind == "stop":
            break
        if kind == "cast":
            _, op, payload = msg
            if op == "cancel":
                req = local.get(int(payload.get("rid", -1)))
                if req is not None:
                    req.cancel_flag = True
            continue
        _, seq, op, payload = msg
        fn = ops.get(op)
        if fn is None:
            evt_q.put(("reply", seq, False, f"unknown op {op!r}"))
            continue
        try:
            out = fn(payload or {})
            check_plain(out, f"reply to {op!r}")
            evt_q.put(("reply", seq, True, out))
        except BaseException as e:   # engine errors must not kill the
            evt_q.put(("reply", seq, False,   # worker loop
                       f"{type(e).__name__}: {e}"))
        if op == "shutdown":
            break
