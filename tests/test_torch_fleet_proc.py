"""The worker-process serving fleet of the PyTorch port
(``paddle_tpu_torch/serving/fleet/proc``), held against the JAX package.

Mirrors tests/test_fleet_proc.py on a tiny 2-layer f32 Llama, page 4.
Workers run on the CPU (``device="cpu"``, one thread each); weights go
from the port to JAX: ``init_params`` from a CPU generator seeded 0 in
every worker and here, then ``params_to_numpy`` into the JAX
``ServingEngine``, which is the reference for every stream (greedy
tokens exact). The process boundary must be invisible to a request's
math, across a SIGKILLed worker (exactly-once re-dispatch), a KV-chain
migration between workers and the prefill->decode handoff. The wire
dicts and the transport's frame-order enforcement equal the JAX
package's on the same inputs, and no tensor crosses the boundary.

Every test runs under a hard SIGALRM limit, so a hung worker fails the
test instead of wedging the run.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.fleet.proc import WorkerTransport as JTransport
from paddle_tpu.serving.fleet.proc import \
    request_from_wire as j_request_from_wire
from paddle_tpu.serving.fleet.proc import \
    request_to_wire as j_request_to_wire
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.fleet.proc import (ProcServingFleet,
                                                 TransportError,
                                                 TransportTimeout,
                                                 WorkerSpec,
                                                 WorkerTransport,
                                                 request_from_wire,
                                                 request_to_wire)
from paddle_tpu_torch.serving.fleet.proc.wire import check_plain
from paddle_tpu_torch.serving.prefix_cache import prefix_fingerprints
from paddle_tpu_torch.serving.scheduler import Request, RequestHandle

_HARD_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _hard_timeout():
    def _boom(signum, frame):
        raise TimeoutError(
            f"fleet-proc test exceeded hard {_HARD_TIMEOUT_S}s limit")
    old = signal.signal(signal.SIGALRM, _boom)
    signal.alarm(_HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


CFG_KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128,
              dtype="float32", use_flash_attention=False, remat=False)
ENGINE_KW = dict(max_batch=4, page_size=4, max_prompt_len=16,
                 max_new_tokens_cap=16)
SPEC = WorkerSpec(cfg_kw=CFG_KW, params_seed=0, engine_kw=ENGINE_KW,
                  device="cpu", env={"OMP_NUM_THREADS": "1"}, warm=False)
TCFG = TL.LlamaConfig(**{**CFG_KW, "dtype": torch.float32})
JCFG = JL.LlamaConfig(**{**CFG_KW, "dtype": jnp.float32})
HEADER = list(range(1, 9))              # 8 tokens = 2 full pages


@pytest.fixture(scope="module")
def tparams():
    return TL.init_params(TCFG, torch.Generator().manual_seed(0),
                          device="cpu")


@pytest.fixture(scope="module")
def ref_engine(tparams):
    """The JAX engine on the port's weights: every stream's reference."""
    jp = jax.tree_util.tree_map(jnp.asarray, TL.params_to_numpy(tparams))
    eng = JEngine(jp, JCFG, **ENGINE_KW)
    yield eng
    eng.close()


_REFS = {}


def _ref(ref_engine, prompt, n):
    key = (tuple(int(t) for t in prompt), int(n))
    if key not in _REFS:
        _REFS[key] = np.asarray(ref_engine.generate(list(key[0]), n))
    return _REFS[key]


@pytest.fixture(scope="module")
def fleet():
    """ONE 2-worker fleet shared by the module (spawn + engine build is
    the expensive part); the kill test runs LAST in file order and
    consumes it."""
    f = ProcServingFleet(SPEC, replicas=2, policy="round_robin")
    yield f
    f.close()


def _wait_counter(rep, key, at_least, timeout=60.0) -> dict:
    """A worker's snapshot counters once ``key`` reached ``at_least``: a
    handle resolves inside the worker's tick, before the tick's counters
    are in."""
    deadline = time.monotonic() + timeout
    while True:
        c = (rep.snapshot_dict() or {}).get("counters", {})
        if c.get(key, 0) >= at_least or time.monotonic() > deadline:
            return c
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# wire schema
# ---------------------------------------------------------------------------

def test_request_wire_roundtrip():
    """Request parameters survive the hop, the dict equals the JAX
    package's on the same request (deadline aside: it is the REMAINING
    seconds at the call) and both twins agree."""
    req = Request([1, 2, 3], 4, eos_token_id=7,
                  deadline_s=time.monotonic() + 5.0,
                  temperature=0.5, top_p=0.9, top_k=3, seed=11)
    w = request_to_wire(req)
    jw = j_request_to_wire(req)
    assert w["rid"] == req.id and w["prompt"] == [1, 2, 3]
    assert 0.0 < w["deadline"] <= 5.0 and 0.0 < jw["deadline"] <= 5.0
    assert {k: v for k, v in w.items() if k != "deadline"} == \
        {k: v for k, v in jw.items() if k != "deadline"}
    for twin in (request_from_wire(w), j_request_from_wire(w)):
        np.testing.assert_array_equal(twin.prompt, req.prompt)
        assert (twin.max_new_tokens, twin.eos_token_id, twin.temperature,
                twin.top_p, twin.top_k, twin.seed) == (4, 7, 0.5, 0.9, 3,
                                                       11)
        assert twin.deadline_s is not None
    assert request_from_wire(
        request_to_wire(Request([1], 1))).deadline_s is None
    # the spec: the card unless asked, and no env pinned by default
    spec = WorkerSpec()
    assert spec.device is None and spec.env == {}


def test_wire_refuses_tensor_payloads(fleet):
    """A torch.Tensor anywhere in a payload is refused: it would cross
    the queue as a shared-memory handle, not by value. numpy passes."""
    check_plain({"k": np.zeros((2, 2), np.uint16), "xs": [1, (2.0, "a")]})
    for bad in (torch.zeros(2), {"k": torch.zeros(2)},
                {"a": [1, {"b": (torch.ones(1),)}]}):
        with pytest.raises(TypeError, match="torch.Tensor"):
            check_plain(bad)
    # the adopt path refuses before anything reaches the worker
    r0 = fleet.replicas()[0]
    blob = {"page_size": 4, "tokens": [tuple(range(4))],
            "k": torch.zeros((2, 2, 1, 4, 16)),
            "v": np.zeros((2, 2, 1, 4, 16), np.float32)}
    with pytest.raises(TypeError, match="torch.Tensor"):
        r0.adopt_chain(blob)
    with pytest.raises(TypeError, match="torch.Tensor"):
        r0.adopt_chain_chunk(1, 0, np.zeros(1), torch.zeros(1))
    assert r0.serving


def test_worker_reply_path_refuses_tensors(monkeypatch):
    """The worker answers an rpc whose result holds a tensor as a failed
    rpc (the loop runs here on plain queues, over a stub engine)."""
    import queue as _queue
    import types

    from paddle_tpu_torch.serving.fleet.proc import worker as W

    stub = types.SimpleNamespace(
        pool=types.SimpleNamespace(page_size=4),
        scheduler=types.SimpleNamespace(max_batch=2),
        on_chain_complete=None,
        gauges=lambda: {"queued": torch.zeros(())},
        snapshot=lambda: {"counters": {"completed": 1}})
    monkeypatch.setattr(W, "_build_engine",
                        lambda spec: (stub, torch.device("cpu"), 0.0))
    cmd, evt = _queue.Queue(), _queue.Queue()
    for m in (("rpc", 1, "gauges", {}), ("rpc", 2, "snapshot", {}),
              ("stop",)):
        cmd.put(m)
    W._run(WorkerSpec(device="cpu"), cmd, evt)
    frames = [evt.get_nowait() for _ in range(evt.qsize())]
    assert frames[0][0] == "ready" and frames[0][1]["device"] == "cpu"
    (_, s1, ok1, p1), (_, s2, ok2, p2) = frames[1:]
    assert (s1, ok1) == (1, False) and "torch.Tensor" in p1, p1
    assert (s2, ok2, p2) == (2, True, {"counters": {"completed": 1}})


# ---------------------------------------------------------------------------
# transport units: the same frames through both packages' demux
# ---------------------------------------------------------------------------

def _shell_transport(cls):
    """A transport shell around the frame demux only."""
    t = object.__new__(cls)
    t.name = "shell"
    t._lock = threading.Lock()
    t._waiters = {}
    t._fseq = {}
    t.frame_violations = 0
    t.ready = None
    t._ready_evt = threading.Event()
    t._fatal = None
    got = []
    t.on_frame = got.append
    t.on_event = None
    return t, got


FRAMES = [("tok", 1, 0, 10), ("tok", 1, 2, 12), ("tok", 1, 1, 11),
          ("tok", 1, 1, 11), ("done", 1, 2, "completed", ""),
          ("tok", 2, 0, 5), ("done", 2, 3, "completed", ""),
          ("tok", 3, 0, 9), ("done", 3, 0, "completed", ""),
          ("tok", 3, 1, 8), ("done", 3, 2, "cancelled", "x")]


def test_frame_ordering_enforced_as_jax():
    """Per-request fseq must count 0,1,2,...; an out-of-order frame is
    counted and DROPPED. The same frame sequence through both packages'
    ``_feed`` delivers the same frames and counts the same
    violations."""
    t, got = _shell_transport(WorkerTransport)
    jt, jgot = _shell_transport(JTransport)
    counts = []
    for msg in FRAMES:
        t._feed(msg)
        jt._feed(msg)
        counts.append((t.frame_violations, jt.frame_violations))
    assert got == jgot
    assert [a for a, _ in counts] == [b for _, b in counts]
    assert t.frame_violations == 4
    assert [m[3] for m in got if m[0] == "tok" and m[1] == 1] == [10, 11]
    assert sum(1 for m in got if m[0] == "done") == 2


def test_frame_reply_resolves_waiter():
    t, _ = _shell_transport(WorkerTransport)
    ev = threading.Event()
    slot = [ev, None, None]
    t._waiters[7] = slot
    t._feed(("reply", 7, True, {"x": 1}))
    assert ev.is_set() and slot[1] is True and slot[2] == {"x": 1}
    # a reply for a popped (timed-out) waiter is discarded quietly
    t._feed(("reply", 7, True, {"x": 2}))
    assert slot[2] == {"x": 1}


# ---------------------------------------------------------------------------
# migration mechanics, in-process (export_chain / adopt_chain)
# ---------------------------------------------------------------------------

def _chain_fp(tail):
    prompt = np.asarray(HEADER + tail, np.int32)
    return int(prefix_fingerprints(prompt, 4, max_depth=8)[-1])


def test_engine_export_adopt_bitwise(tparams, ref_engine):
    """Prefill on A, export the chain by fingerprint, adopt into B,
    decode on B == the JAX engine, with no processes in the way."""
    a = ServingEngine(tparams, TCFG, device="cpu", **ENGINE_KW)
    b = ServingEngine(tparams, TCFG, device="cpu", **ENGINE_KW)
    c = ServingEngine(tparams, TCFG, device="cpu",
                      **{**ENGINE_KW, "page_size": 8})
    try:
        a.generate(HEADER + [50, 51, 52], 6)
        blob = a.export_chain(_chain_fp([50, 51, 52]))
        assert blob is not None and blob["page_size"] == 4
        assert [len(t) for t in blob["tokens"]] == [4, 4]
        assert blob["k"].shape[2] == 2
        check_plain(blob)                   # a blob crosses as is
        assert b.adopt_chain(blob) == {"matched_pages": 0,
                                       "adopted_pages": 2}
        assert b.adopt_chain(blob) == {"matched_pages": 2,
                                       "adopted_pages": 0}
        out = b.generate(HEADER + [60, 61], 6)
        np.testing.assert_array_equal(
            out, _ref(ref_engine, HEADER + [60, 61], 6))
        assert b.snapshot()["counters"]["prefix_hits"] >= 1
        assert a.export_chain(987654321) is None
        with pytest.raises(ValueError, match="page-size mismatch"):
            c.adopt_chain(blob)
    finally:
        for e in (a, b, c):
            e.close()


# ---------------------------------------------------------------------------
# live fleet: parity, refusal, timeout, migration — then the kill
# ---------------------------------------------------------------------------

def _no_jax_mapped(pid: int) -> None:
    """The worker process loaded no native library of JAX (importing
    jax, or anything of the JAX package, maps jaxlib's)."""
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    jaxlib = os.path.dirname(os.path.dirname(jax.__file__))
    assert os.path.join(jaxlib, "jaxlib") not in maps


def test_proc_fleet_parity_and_merged_scrape(fleet, ref_engine):
    """Mixed requests over 2 worker processes: every stream equals the
    JAX engine token for token (same weights by params_seed), and the
    merged scrape carries both workers."""
    reps = fleet.replicas()
    for r in reps:
        assert r.pid != os.getpid()
        assert r._t.ready["device"] == "cpu"
        assert r._t.ready["pid"] == r.pid
        _no_jax_mapped(r.pid)
    rng = np.random.RandomState(0)
    specs = [(rng.randint(1, 256,
                          (int(rng.randint(2, 12)),)).tolist(),
              int(rng.randint(2, 10))) for _ in range(8)]
    handles = [fleet.submit(p, m) for p, m in specs]
    outs = [h.result(timeout=180) for h in handles]
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(ref_engine, p, m))
    snap = fleet.snapshot()
    served = {n: h["counters"]["completed"]
              for n, h in snap["replicas"].items() if "counters" in h}
    assert all(v > 0 for v in served.values()) and len(served) == 2
    text = fleet.expose()
    types = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))         # one TYPE per family
    assert 'replica="w0"' in text and 'replica="w1"' in text
    assert "paddle_serving_fleet_generation" in text
    for t in (r._t for r in reps):
        assert t.frame_violations == 0


def test_oversized_prompt_refused_not_crashed(fleet):
    r0 = fleet.replicas()[0]
    big = Request(list(range(1, 31)), 4)        # 30 > max_prompt_len 16
    assert r0.inject(big) is False
    with pytest.raises(RuntimeError, match="no serving replica"):
        fleet.submit(list(range(1, 31)), 4)
    assert r0.serving and r0.alive


def test_never_ack_worker_times_out(fleet):
    """A SIGSTOPped worker raises TransportTimeout instead of wedging
    the caller; after SIGCONT the same transport serves rpcs again."""
    rep = fleet.replicas()[1]
    os.kill(rep.pid, signal.SIGSTOP)
    try:
        with pytest.raises(TransportTimeout):
            rep._rpc("ping", timeout=1.0)
    finally:
        os.kill(rep.pid, signal.SIGCONT)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            assert rep._rpc("ping", timeout=5.0)["pid"] == rep.pid
            break
        except TransportError:
            time.sleep(0.2)
    else:
        pytest.fail("worker did not recover after SIGCONT")


def test_unknown_op_is_an_error_not_a_hang(fleet):
    with pytest.raises(TransportError, match="unknown op"):
        fleet.replicas()[0]._rpc("no_such_op", timeout=10.0)


def test_kv_migration_between_workers(fleet, ref_engine):
    """Prefill on worker A -> migrate the chain's pages by fingerprint
    (chunked, numpy across the pipe) -> decode on worker B equal to the
    JAX engine, with real prefix hits on B."""
    r0, r1 = fleet.replicas()[:2]
    warm = Request(HEADER + [50, 51, 52], 6)
    assert r0.inject(warm)
    RequestHandle(warm).result(timeout=180)
    fp = _chain_fp([50, 51, 52])
    before = (r1.snapshot_dict() or {}).get("counters", {})
    assert fleet.migrate_chain(fp, r0.name, r1.name) == \
        {"matched_pages": 0, "adopted_pages": 2}
    assert fleet.migrate_chain(fp, r0.name, r1.name) == \
        {"matched_pages": 2, "adopted_pages": 0}
    assert fleet.migrate_chain(123456789, r0.name, r1.name) is None
    cont = Request(HEADER + [60, 61], 6)
    assert r1.inject(cont)
    out = RequestHandle(cont).result(timeout=180)
    np.testing.assert_array_equal(
        out, _ref(ref_engine, HEADER + [60, 61], 6))
    after = _wait_counter(r1, "prefix_hits",
                          before.get("prefix_hits", 0) + 1)
    assert after.get("prefix_hits", 0) > before.get("prefix_hits", 0)


def test_prefill_decode_auto_handoff(tparams):
    """Roles [prefill, decode] over two workers: turn 1 (prompt-heavy)
    runs on the prefill worker, its chain crosses to the decode worker
    on its own (auto_migrate, chunked), turn 2 routes there by the
    migration record, attaches the whole chain and decodes JAX
    generate()'s tokens."""
    rng = np.random.RandomState(8)
    first = rng.randint(0, 256, 12).astype(np.int32)     # 3 pages of 4
    jp = jax.tree_util.tree_map(jnp.asarray, TL.params_to_numpy(tparams))

    def jgen(prompt, n):
        out = JL.generate(jp, jnp.asarray(prompt, jnp.int32)[None], JCFG,
                          max_new_tokens=n)
        return np.asarray(out)[0, len(prompt):]
    with ProcServingFleet(SPEC, replicas=2, roles=["prefill", "decode"],
                          prefill_len_ratio=2.0, health_ttl_s=0,
                          migrate_chunk_pages=2) as f:
        assert f.auto_migrate
        reps = {r.role: r for r in f.replicas()}
        out1 = f.submit(first, 4).result(timeout=120)
        deadline = time.monotonic() + 60
        while f.counters["migrations"] + f.counters["migration_failed"] \
                < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert f.counters["migrations"] == 1, f.counters
        assert f.counters["migration_failed"] == 0
        c0 = _wait_counter(reps["decode"], "completed", 0)
        turn2 = np.concatenate([first, out1,
                                rng.randint(0, 256, 2).astype(np.int32)])
        turn2 = turn2[:15]
        out2 = f.submit(turn2, 12).result(timeout=120)
        assert f.router.counters["routed_migrated"] == 1
        c1 = _wait_counter(reps["decode"], "completed",
                           c0["completed"] + 1)
        assert c1["completed"] - c0["completed"] == 1
        assert c1["prefix_hit_tokens"] - c0["prefix_hit_tokens"] == 12
    np.testing.assert_array_equal(out1, jgen(first, 4))
    np.testing.assert_array_equal(out2, jgen(turn2, 12))


def test_default_device_worker_refuses_the_cpu():
    """A spec without a device asks for the card: with no CUDA the
    worker raises at build, the fleet's bring-up fails naming it, and
    nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the worker would run")
    spec = WorkerSpec(cfg_kw=CFG_KW, engine_kw=ENGINE_KW,
                      env={"OMP_NUM_THREADS": "1"})
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcServingFleet(spec, replicas=1)


def test_sigkill_mid_stream_zero_drops_exactly_once(fleet, ref_engine):
    """SIGKILL a worker while it streams: the crash is detected, every
    unfinished request is handed back and re-dispatched to the survivor,
    and every handle completes equal to the JAX engine (the re-decoded
    prefix is deduped: no token twice), with a clean survivor sentinel.
    Runs LAST in file order: it consumes the module fleet."""
    rng = np.random.RandomState(3)
    specs = [(rng.randint(1, 256,
                          (int(rng.randint(2, 12)),)).tolist(), 12)
             for _ in range(10)]
    for rep in fleet.replicas():
        rep._rpc("warm_programs", timeout=180.0)
    fleet.arm_sentinels()
    handles = [fleet.submit(p, m) for p, m in specs]
    time.sleep(0.3)                     # let streams start
    victim, survivor = fleet.replicas()[:2]
    fleet.kill_hard(victim.name, timeout=60)
    outs = [h.result(timeout=180) for h in handles]
    for (p, m), out, h in zip(specs, outs, handles):
        assert h.status == "completed"
        np.testing.assert_array_equal(out, _ref(ref_engine, p, m))
        assert len(out) <= m
    snap = fleet.snapshot()
    assert snap["fleet"]["crashes"] == 1
    assert snap["router"]["redispatch_failed"] == 0
    assert victim.state == "gone"
    assert all(r.name != victim.name for r in fleet.router.replicas())
    s = survivor.sentinel_report()
    assert s is None or s.get("clean", True)
