"""Runtime observability of the PyTorch port (``paddle_tpu_torch/
observability`` and ``serving/locktrace.py``), held against the JAX
package.

Tiny 2-layer f32 Llama, page 4, as tests/test_observability.py, weights
carried over from the JAX params:

* the span tracer's Chrome-trace JSON equals JAX's for the same calls,
  timestamps aside; nesting, threads, the ring bound, ``enabled=False``;
* the engine's trace reconciles with its metrics by counts, and
  ``snapshot()`` runs beside the loop;
* the flight recorder's ring and dump, and the postmortem of a seeded
  invariant error, carry the JAX documents' keys and violation kinds;
* the recompile sentinel trips on a load event fired inside a tick after
  ``arm()``, stays clean after ``warm_programs()``, and ``_build.load``
  is its event source;
* the lock tracer's stats, passthrough, a seeded inversion, the
  fuzzer's seeded decisions, and the engine's ``host_sync_held`` keys
  equal the JAX engine's on the same traffic.
"""
import ctypes.util
import dataclasses
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.observability import FlightRecorder as JFlightRecorder
from paddle_tpu.observability import SpanTracer as JSpanTracer
from paddle_tpu.observability import current_span as j_current_span
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import locktrace as jlocktrace
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ
from paddle_tpu_torch.observability import (COMPILE_EVENT, FlightRecorder,
                                            RecompileSentinel,
                                            RecompileWarning, SpanTracer,
                                            current_span, sentinel)
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.serving import (ServingEngine, locktrace,
                                      prefix_fingerprints)

JCFG = dataclasses.replace(
    JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                        remat=False), num_hidden_layers=2)
TCFG = dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32),
                           num_hidden_layers=2)
ENGINE_KW = dict(max_batch=4, page_size=4, max_prompt_len=16,
                 max_new_tokens_cap=16)


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


def _engine(tparams, **kw):
    return ServingEngine(tparams, TCFG, device="cpu", **{**ENGINE_KW, **kw})


def _jengine(jparams, **kw):
    return JEngine(jparams, JCFG, **{**ENGINE_KW, **kw})


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

def _drive_tracer(tr, current):
    """One fixed sequence of tracer calls; ``current`` is the package's
    ``current_span``."""
    with tr.span("outer", track="engine.decode", tick=1):
        assert current() == "outer"
        with tr.span("inner", track="engine.decode"):
            assert current() == "inner"
        assert current() == "outer"
    assert current() is None

    def worker():
        with tr.span("w", track="slot1"):
            pass
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    tr.add("retro", "slot0", 1.0, 2.5, req=7)
    tr.instant("mark", "slot10", i=3)
    tr.add("q", "slot2", 3.0, 3.0)
    tr.add("compile during serving.tick", "sentinel", 4.0, 4.5,
           compile_s=0.5)
    tr.instant("retire", "engine.admission", state="completed")


def _untimed(doc):
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
           for e in doc["traceEvents"]]
    return dict(doc, traceEvents=evs)


def test_tracer_roundtrip_nesting_and_threads_match_jax(tmp_path):
    tr = SpanTracer(capacity=128)
    _drive_tracer(tr, current_span)
    path = tr.export(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    byname = {e["name"]: e for e in evs}
    assert {"outer", "inner", "w", "retro"} <= set(byname)
    assert all(e["dur"] >= 0 for e in evs)
    o, i = byname["outer"], byname["inner"]
    assert i["tid"] == o["tid"]
    assert i["ts"] >= o["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert byname["retro"]["dur"] == pytest.approx(1.5e6)  # us
    assert byname["retro"]["args"]["req"] == 7
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"]
    # engine tracks first, slots in numeric order (slot10 after slot2)
    assert names == ["engine.admission", "engine.decode", "sentinel",
                     "slot0", "slot1", "slot2", "slot10"]
    jtr = JSpanTracer(capacity=128)
    _drive_tracer(jtr, j_current_span)
    assert _untimed(doc) == _untimed(jtr.to_chrome_trace())


def test_tracer_ring_bound_and_disable_match_jax():
    def drive(tr_cls):
        tr = tr_cls(capacity=8)
        for i in range(20):
            tr.instant("e", "t", i=i)
        return tr
    tr, jtr = drive(SpanTracer), drive(JSpanTracer)
    assert len(tr.spans()) == 8 and tr.dropped == 12
    assert [s.args["i"] for s in tr.spans()] == list(range(12, 20))
    assert [(s.name, s.track, s.args) for s in tr.spans()] == \
        [(s.name, s.track, s.args) for s in jtr.spans()]
    assert tr.dropped == jtr.dropped
    off = SpanTracer(enabled=False)
    with off.span("x"):
        # disabled tracers record nothing but still publish the name
        assert current_span() == "x"
    assert current_span() is None
    off.add("y", "t", 0.0, 1.0)
    off.instant("z", "t")
    assert off.spans() == []


# ---------------------------------------------------------------------------
# engine wiring
# ---------------------------------------------------------------------------

def test_engine_trace_reconciles_with_metrics(tparams, tmp_path):
    """The exported timeline parses; per request: queue, ttft and request
    spans, the ttft span on the ttft_s observation's own stamps; counts:
    serving.tick spans = ticks, request spans = completed, queue spans =
    admitted, ttft spans = ttft_s observations."""
    rng = np.random.RandomState(0)
    specs = [(rng.randint(0, 256, (n,)).astype(np.int32), m)
             for n, m in ((3, 4), (7, 3), (12, 5), (5, 6))]
    with _engine(tparams, trace=True) as eng:
        handles = [eng.submit(p, m) for p, m in specs]
        outs = [h.result(timeout=120) for h in handles]
    path = eng.export_trace(str(tmp_path / "serve.json"))
    doc = json.load(open(path))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in evs)
    by_req = {}
    for e in evs:
        if "req" in e.get("args", {}):
            by_req.setdefault(e["args"]["req"], {}) \
                  .setdefault(e["name"], []).append(e)
    for h, out in zip(handles, outs):
        spans = by_req[h.id]
        assert {"queue", "ttft", "request"} <= set(spans)
        assert len(spans["request"]) == len(spans["ttft"]) == 1
        assert spans["ttft"][0]["dur"] == pytest.approx(h.ttft_s * 1e6,
                                                        abs=2.0)
        req_span = spans["request"][0]
        assert req_span["args"]["state"] == "completed"
        assert req_span["args"]["tokens"] == len(out)
        # one decode span per tick that decoded it: each token after the
        # first comes from a decode tick (decode_block 1)
        assert len(spans.get("decode", [])) == len(out) - 1
    c = eng.snapshot()["counters"]
    h = eng.snapshot()["histograms"]

    def count(name):
        return sum(e["name"] == name for e in evs)
    assert count("serving.tick") == c["ticks"]
    assert count("request") == c["completed"] == len(specs)
    assert count("queue") == c["admitted"]
    assert count("ttft") == h["ttft_s"]["count"]
    assert count("prefill.chunk") == c["prefill_chunks"]
    tracks = {e["cat"] for e in evs}
    assert {"engine.decode", "engine.admission", "engine.audit"} <= tracks
    assert any(t.startswith("slot") for t in tracks)
    assert len(eng.flight.ticks()) == min(c["ticks"], eng.flight.capacity)


def test_engine_snapshot_concurrent_with_loop(tparams):
    rng = np.random.RandomState(1)
    stop = threading.Event()
    errs = []

    def hammer(eng):
        while not stop.is_set():
            try:
                snap = eng.snapshot()
                assert set(snap) == {"counters", "labeled",
                                     "histograms", "gauges"}
                assert "free_pages" in snap["gauges"]
                assert "paddle_serving_submitted_total" in eng.expose()
            except Exception as e:      # surfaced after join
                errs.append(e)
                return
    with _engine(tparams, prefill_chunk=4) as eng:
        threads = [threading.Thread(target=hammer, args=(eng,))
                   for _ in range(2)]
        for t in threads:
            t.start()
        handles = [eng.submit(
            rng.randint(0, 256, (rng.randint(2, 16),)).astype(np.int32),
            int(rng.randint(2, 10))) for _ in range(12)]
        for h in handles:
            h.result(timeout=120)
        stop.set()
        for t in threads:
            t.join()
    assert not errs
    assert eng.snapshot()["counters"]["completed"] == 12


# ---------------------------------------------------------------------------
# flight recorder and postmortem
# ---------------------------------------------------------------------------

def test_flight_recorder_ring_and_dump_match_jax(tmp_path):
    docs = []
    for cls, rows in ((FlightRecorder, torch.arange(3)),
                      (JFlightRecorder, np.arange(3))):
        fr = cls(capacity=3)
        for i in range(5):
            fr.record_tick(tick=i, dur_s=0.001 * i)
        assert [t["tick"] for t in fr.ticks()] == [2, 3, 4]
        p = fr.dump(str(tmp_path / f"{cls.__module__}.json"),
                    error=ValueError("boom"),
                    geometry="engine geometry: page_size=4",
                    state={"slots": [], "rows": rows},
                    programs=["ragged_paged_attention"],
                    metrics={"counters": {"ticks": np.int64(5)}},
                    sentinel={"clean": True}, spans=[])
        docs.append(json.load(open(p)))
    doc, jdoc = docs
    assert doc["schema"] == "paddle_tpu.flight_recorder/1"
    assert doc["error"]["type"] == "ValueError"
    assert doc["state"]["rows"] == [0, 1, 2]     # torch tensor coerced
    assert len(doc["ticks"]) == 3
    for d in (doc, jdoc):
        d.pop("written_unix_s")
    assert doc == jdoc


def _seed_invariant_error(eng, rng):
    """The JAX test's corruption: a cached node's refcount drifts while a
    request decodes; the next tick's audit fails the engine."""
    eng.submit(rng.randint(0, 256, (9,)).astype(np.int32), 4) \
       .result(timeout=120)
    h = eng.submit(rng.randint(0, 256, (9,)).astype(np.int32), 12)
    it = iter(h)
    next(it)
    with eng._tick_lock:
        nodes = eng.prefix_cache.nodes()
        assert nodes
        nodes[0].refs += 3
    with pytest.raises(Exception, match="invariant"):
        h.result(timeout=120)
    # the dump runs on the dying worker before the handles fail
    return eng.postmortem_path


def test_postmortem_on_seeded_invariant_error_matches_jax(
        tparams, jparams, tmp_path):
    """A seeded KVInvariantError kills the engine and ships a postmortem
    whose keys and violation kinds equal the JAX engine's on the same
    corruption."""
    docs = []
    for name, make in (("port", _engine), ("jax", _jengine)):
        fdir = str(tmp_path / name)
        eng = make(tparams if name == "port" else jparams,
                   check_invariants=True, flight_dir=fdir,
                   tick_interval_s=0.005)
        try:
            path = _seed_invariant_error(eng, np.random.RandomState(3))
            assert path is not None and os.path.dirname(path) == fdir
            docs.append(json.load(open(path)))
        finally:
            eng.close(drain=False)
    doc, jdoc = docs
    assert doc["error"]["type"] == "KVInvariantError"
    codes = sorted(v["code"] for v in doc["error"]["violations"])
    assert "refcount-drift" in codes
    assert codes == sorted(v["code"] for v in jdoc["error"]["violations"])
    assert set(doc) == set(jdoc)
    for k in ("error", "state", "sentinel"):
        assert set(doc[k]) == set(jdoc[k]), k
    assert set(doc["metrics"]) == set(jdoc["metrics"])
    assert set(doc["ticks"][-1]) == set(jdoc["ticks"][-1])
    assert set(doc["state"]["slots"][0]) == set(jdoc["state"]["slots"][0])
    assert "engine geometry:" in doc["geometry"]
    assert doc["expected_programs"] == ["ragged_paged_attention"]
    assert doc["ticks"] and doc["state"]["slots"]
    assert any(s["name"] == "serving.tick" for s in doc["spans"])
    assert doc["metrics"]["counters"]["invariant_violations"] >= 1


# ---------------------------------------------------------------------------
# recompile sentinel
# ---------------------------------------------------------------------------

def test_sentinel_trips_on_a_load_inside_a_tick(tparams, monkeypatch):
    """A synthetic library-load event fired from inside a tick after
    arm(): post_warmup_compiles, the event named after serving.tick, a
    RecompileWarning, the labeled recompiles counter and a sentinel
    span. The same event before arm() is a warmup load."""
    fire = threading.Event()
    real_tick = TL.serving_tick

    def tick(*a, **kw):
        if fire.is_set():
            fire.clear()
            sentinel.record_event_duration_secs(COMPILE_EVENT, 0.25,
                                                library="synthetic")
        return real_tick(*a, **kw)
    monkeypatch.setattr(TL, "serving_tick", tick)
    rng = np.random.RandomState(5)
    eng = _engine(tparams, recompile_sentinel=True)
    try:
        fire.set()
        eng.submit(rng.randint(0, 256, (5,)).astype(np.int32), 3) \
           .result(timeout=120)
        rep0 = eng.sentinel.report()
        assert rep0["warmup_compiles"] == 1 and rep0["clean"]
        eng.arm_sentinel()
        eng.submit(rng.randint(0, 256, (4,)).astype(np.int32), 3) \
           .result(timeout=120)
        assert eng.sentinel.report()["clean"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fire.set()
            eng.submit(rng.randint(0, 256, (6,)).astype(np.int32), 3) \
               .result(timeout=120)
        rep = eng.sentinel.report()
        assert rep["post_warmup_compiles"] == 1 and not rep["clean"]
        post = [e for e in rep["events"] if e["phase"] == "post_warmup"]
        assert [(e["during"], e["library"]) for e in post] == \
            [("serving.tick", "synthetic")]
        assert any(isinstance(w.message, RecompileWarning)
                   for w in caught)
        snap = eng.snapshot()
        assert snap["counters"]["recompiles"] == 1
        assert [(lbl["labels"], lbl["value"])
                for lbl in snap["labeled"]["recompiles"]] == \
            [({"during": "serving.tick"}, 1)]
        assert [s.name for s in eng.tracer.spans()
                if s.track == "sentinel"] == ["compile during serving.tick"]
        assert "paddle_serving_recompiles_total 1" in \
            eng.expose().splitlines()
    finally:
        eng.close()


def test_sentinel_clean_after_warm_programs(tparams, jparams):
    """warm_programs() then arm() stays clean through traffic; the
    expected inventory is the engine's kernel libraries (the int8 kernel
    added for int8 weights, the same list for Qwen2-MoE); a closed
    engine's sentinel is detached."""
    rng = np.random.RandomState(6)
    with _engine(tparams, decode_block_size=2) as eng:
        assert eng.warm_programs() == 3     # tail 1, tail 0, the block
        eng.arm_sentinel()
        for _ in range(3):
            eng.submit(rng.randint(0, 256, (7,)).astype(np.int32), 5) \
               .result(timeout=120)
        rep = eng.sentinel.report()
        assert rep["armed"] and rep["clean"]
        assert rep["expected_programs"] == eng.program_inventory \
            == ["ragged_paged_attention"]
        assert set(rep) == {"label", "armed", "warmup_compiles",
                            "post_warmup_compiles", "clean",
                            "expected_programs", "events"}
        assert eng.audit() == []
    assert eng.sentinel._closed
    with _engine(tparams, speculative="ngram", spec_k=2) as spec:
        assert spec.warm_programs() == 2    # the verify tick, the block
        assert spec.audit() == []
    with _engine(tparams, quantization="int8",
                 recompile_sentinel=False) as q:
        assert q.program_inventory == ["int8_matmul",
                                       "ragged_paged_attention"]
        assert q.sentinel is None
    qcfg = dataclasses.replace(TQ.Qwen2MoeConfig.tiny(dtype=torch.float32),
                               num_hidden_layers=1)
    qparams = TQ.init_params(qcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with ServingEngine(qparams, qcfg, device="cpu", **ENGINE_KW) as qe:
        assert qe.program_inventory == list(TQ.SERVING_KERNELS)
        assert qe.warm_programs() == 2
        qe.arm_sentinel()
        qe.generate(np.arange(1, 6, dtype=np.int32), 3)
        assert qe.sentinel.report()["clean"]


def test_build_load_is_the_sentinel_event_source(monkeypatch):
    """``_build.load`` records each library's first load in the process
    (and only the first) as COMPILE_EVENT with its name."""
    libc = ctypes.util.find_library("c")
    assert libc
    monkeypatch.setattr(_build, "build",
                        lambda names: {n: libc for n in names})
    monkeypatch.setattr(_build, "_loaded", {})
    s = RecompileSentinel(label="probe")
    try:
        _build.load("probe_a")
        _build.load("probe_a")
        rep = s.report()
        assert rep["warmup_compiles"] == 1
        assert [e["library"] for e in rep["events"]] == ["probe_a"]
        s.arm()
        with pytest.warns(RecompileWarning, match="probe_b"):
            _build.load("probe_b")
        assert s.report()["post_warmup_compiles"] == 1
    finally:
        s.close()
    _build.load("probe_c")          # a closed sentinel sees nothing
    assert s.report()["warmup_compiles"] == 1


# ---------------------------------------------------------------------------
# lock tracer
# ---------------------------------------------------------------------------

def test_lock_tracer_wait_hold_and_host_sync_stats():
    tr = locktrace.LockTracer()
    a = locktrace.TracedLock(threading.Lock(), "A")
    try:
        locktrace.enable(tracer=tr)
        with a:
            locktrace.host_sync("unit.sync")
        locktrace.host_sync("unit.free")    # no lock held: not counted
        rep = tr.report()
    finally:
        locktrace.disable()
    assert rep["wait_s"]["A"]["n"] == 1
    assert rep["hold_s"]["A"]["n"] == 1
    assert rep["host_sync_held"] == {"unit.sync|A": 1}
    assert rep["inversions"] == [] and rep["edges"] == []


def test_wrap_lock_is_passthrough_until_enabled(monkeypatch):
    monkeypatch.setattr(locktrace, "_STATE", locktrace._State())
    raw = threading.Lock()
    assert locktrace.wrap_lock(raw, "unit.raw") is raw
    locktrace.host_sync("unit.sync")        # no tracer: a no-op
    locktrace.fuzz_point("unit.point")
    tr = locktrace.enable()
    locktrace.disable()
    # once enabled, wrapping sticks (engines built between a disable and
    # an enable stay traceable) and the wrapper still locks
    lk = locktrace.wrap_lock(raw, "unit.raw")
    assert isinstance(lk, locktrace.TracedLock)
    with lk:
        assert raw.locked()
    assert not raw.locked()
    assert tr.report()["wait_s"] == {}


def test_seeded_lock_order_inversion_caught():
    a = locktrace.TracedLock(threading.Lock(), "DemoPair._a")
    b = locktrace.TracedLock(threading.Lock(), "DemoPair._b")
    tr = locktrace.enable()
    try:
        def ab():
            with a, b:
                pass

        def ba():
            with b, a:
                pass
        for fn in (ab, ba):                 # two threads, in turn
            t = threading.Thread(target=fn)
            t.start()
            t.join()
    finally:
        locktrace.disable()
    assert len(tr.inversions) == 1
    inv = tr.inversions[0]
    assert (inv["held"], inv["acquiring"]) == ("DemoPair._b", "DemoPair._a")
    assert [e[:2] for e in tr.edges()] == [("DemoPair._a", "DemoPair._b"),
                                           ("DemoPair._b", "DemoPair._a")]


def test_schedule_fuzzer_decisions_match_jax(monkeypatch):
    """Same seed, same perturbation sequence as the JAX fuzzer."""
    def decisions(mod, seed):
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        f = mod.ScheduleFuzzer(seed)
        for i in range(200):
            f.pause(f"p{i}")
        monkeypatch.undo()
        return slept, f.points
    for seed in (0, 1, 17):
        got = decisions(locktrace, seed)
        assert got == decisions(jlocktrace, seed)
        assert got[1] == 200 and 0 < len(got[0]) < 200


def _host_sync_traffic(eng, prompts):
    for p in prompts:
        eng.generate(p, 4)
    fp = prefix_fingerprints(prompts[0], 4, max_depth=64)[-1]
    assert eng.export_chain(int(fp)) is not None


def test_engine_host_sync_keys_match_jax(tparams, jparams):
    """On the same greedy traffic (and one chain export) the port
    engine's locks-held-at-host-sync keys, its lock roles and its
    acquisition edges equal the JAX engine's."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 256, (9,)).astype(np.int32) for _ in range(3)]
    reports = []
    for mod, make, params in ((locktrace, _engine, tparams),
                              (jlocktrace, _jengine, jparams)):
        tr = mod.enable()
        try:
            with make(params) as eng:
                _host_sync_traffic(eng, prompts)
        finally:
            mod.disable()
        reports.append(tr.report())
    rep, jrep = reports
    assert set(rep["host_sync_held"]) == set(jrep["host_sync_held"]) == {
        "serving.tick.readback|ServingEngine._tick_lock",
        "serving.migrate_export|ServingEngine._tick_lock"}
    assert set(rep["wait_s"]) == set(jrep["wait_s"])
    assert {tuple(e[:2]) for e in rep["edges"]} == \
        {tuple(e[:2]) for e in jrep["edges"]}
    assert rep["inversions"] == jrep["inversions"] == []
