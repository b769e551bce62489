"""Wire schema for the multi-process fleet (fleet/proc/).

Port of ``paddle_tpu/serving/fleet/proc/wire.py``. Everything that
crosses the process boundary is defined HERE, as plain picklable data,
so the protocol is auditable in one file:

Worker spec (pickled once, at spawn)
    :class:`WorkerSpec` — enough to rebuild the model + engine inside a
    fresh process: config kwargs (dtype as a STRING, mapped to a torch
    dtype in the worker), a params seed (every worker re-derives
    identical weights from a ``torch.Generator`` seeded with
    ``params_seed`` on its device, which is what makes re-dispatch after
    a crash bitwise-safe), engine kwargs, the device (None = the card,
    as every entry point of the port) and the env to export before the
    worker touches CUDA.

Command frames (parent -> worker, on the command queue)
    ``("rpc", seq, op, payload)``   request/reply; the worker answers
                                    with a ``reply`` frame echoing seq.
    ``("cast", op, payload)``       one-way (e.g. ``cancel`` — best
                                    effort, no reply to wait on).
    ``("stop",)``                   exit the worker loop (after a
                                    shutdown rpc already closed the
                                    engine).

Event frames (worker -> parent, on the event queue)
    ``("ready", info)``             engine built; info carries
                                    ``page_size``/``max_batch``/``pid``,
                                    ``device`` (the worker's device
                                    string, e.g. ``"cuda:0"``) and
                                    ``startup`` (``main_at``: wall clock
                                    at worker_main's entry; ``init_s``,
                                    ``build_s``, ``warm_s``: seconds of
                                    the weights, the whole engine build
                                    and the warm-up).
    ``("reply", seq, ok, payload)`` rpc answer; payload is the result
                                    or, when not ok, an error string.
    ``("tok", rid, fseq, tok)``     ONE generated token for request
                                    ``rid``; ``fseq`` counts 0,1,2,...
                                    per rid — the transport enforces
                                    the monotone order, and re-dispatch
                                    dedup drops ``fseq < skip``.
    ``("done", rid, fseq, state, err)``  terminal frame; fseq equals
                                    the number of tok frames emitted.
    ``("evt", kind, payload)``      out-of-band worker event (no seq,
                                    no ordering contract): the engine's
                                    chain-completion hook surfaces as
                                    ``kind="chain_complete"`` with
                                    ``payload={"rid", "fp", "fps",
                                    "pages", "prompt_tokens"}`` — what
                                    the fleet's migration policy rides
                                    (router-driven prefill→decode
                                    handoff). Delivered to the
                                    transport's ``on_event`` callback;
                                    unknown kinds are dropped.
    ``("fatal", traceback_text)``   worker crashed outside an rpc.

Plain data only: importing torch registers tensor reductions on
``multiprocessing``'s pickler, so a ``torch.Tensor`` put on a queue
would cross as a shared-memory file descriptor (CPU) or a CUDA IPC
handle into the sender's memory, which dies with the sender. Payloads
are therefore numbers, strings, containers and numpy arrays (migration
chunks carry bf16 pages as ``np.uint16`` bits); :func:`check_plain`
refuses a tensor anywhere in a payload, and both the worker's reply
path and the parent's adopt path run it.

Request serialization
    The PARENT-side :class:`~paddle_tpu_torch.serving.scheduler.Request`
    is authoritative: it owns the caller's stream/done machinery and its
    handle must keep working across the hop (and across re-dispatch to
    a different worker). Only the request's *parameters* travel —
    :func:`request_to_wire` — and the worker builds a local twin whose
    tokens are relayed back as ``tok`` frames keyed by the PARENT's
    request id. Deadlines travel as REMAINING seconds because
    ``time.monotonic()`` values are not comparable across processes.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["WorkerSpec", "request_to_wire", "request_from_wire",
           "check_plain"]


@dataclass
class WorkerSpec:
    """Everything a spawned worker needs to build its engine.

    ``cfg_kw`` are ``LlamaConfig`` kwargs with ``dtype`` as a string
    (``"float32"``, ``"bfloat16"``); ``engine_kw`` are ``ServingEngine``
    kwargs. ``params_seed`` seeds the ``torch.Generator`` the weights
    are drawn from on the worker's device — every worker in a fleet must
    use the SAME seed so a re-dispatched request decodes the same stream
    on any replica (greedy/fixed-seed sampling is deterministic given
    identical weights). ``device`` None runs the worker on the card (it
    raises where CUDA is absent); ``"cpu"`` only when asked. ``env`` is
    exported around the spawn and again by the worker before anything
    touches CUDA.
    """
    cfg_kw: dict = field(default_factory=dict)
    params_seed: int = 0
    engine_kw: dict = field(default_factory=dict)
    device: Optional[str] = None
    env: dict = field(default_factory=dict)
    warm: bool = False


def check_plain(obj, what: str = "payload") -> None:
    """Raise TypeError when ``obj`` holds a ``torch.Tensor`` anywhere in
    its dicts, lists and tuples (see the module docstring: a tensor
    would cross by handle, not by value). numpy arrays pass."""
    torch = sys.modules.get("torch")
    if torch is None:
        return              # no torch in this process: no tensor either
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            raise TypeError(
                f"{what} holds a torch.Tensor ({tuple(x.shape)} "
                f"{x.dtype} on {x.device}); frames carry plain data and "
                f"numpy only")
        if isinstance(x, dict):
            stack.extend(x.keys())
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(x)


def request_to_wire(req) -> dict:
    """Serialize a Request's parameters (NOT its caller machinery) for
    the hop; ``rid`` is the parent-side id every later frame keys on."""
    remaining: Optional[float] = None
    if req.deadline_s is not None:
        remaining = req.deadline_s - time.monotonic()
    return {"rid": int(req.id),
            "prompt": [int(t) for t in req.prompt],
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": req.eos_token_id,
            "deadline": remaining,
            "temperature": float(req.temperature),
            "top_p": float(req.top_p),
            "top_k": int(req.top_k),
            "seed": int(req.seed)}


def request_from_wire(d: dict):
    """Build the worker-local twin."""
    from ...scheduler import Request
    timeout = d.get("deadline")
    req = Request(d["prompt"], d["max_new_tokens"],
                  eos_token_id=d.get("eos_token_id"),
                  temperature=d.get("temperature", 0.0),
                  top_p=d.get("top_p", 1.0),
                  top_k=d.get("top_k", 0),
                  seed=d.get("seed", 0))
    if timeout is not None:
        req.deadline_s = time.monotonic() + max(0.0, float(timeout))
    return req
