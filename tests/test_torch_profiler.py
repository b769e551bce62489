"""The port's profiler (``paddle_tpu_torch/profiler``) and
``observability.bridge_record_events`` vs the JAX package's.

Contract (exact): ``make_scheduler``'s states over a grid of windows,
``repeat`` and ``skip_first``; ``RecordEvent`` nesting, manual
``begin`` / ``end`` (``end`` idempotent), ``reset_host_statistics`` and
the bridge into a ``SpanTracer`` on the cases of
``tests/test_observability.py``; a ``timer_only`` summary; the serving
engine's ``serving.tick`` and ``serving.decode_step`` calls in
``host_statistics()`` equal the JAX engine's on the same tiny f32
requests, each run alone (``serving.admit`` is entered once a loop
turn, idle polls included, so its count follows the clock on both
sides). Port only: a recorded window's Chrome trace holds every
``RecordEvent`` range, from any thread, as ``user_annotation`` events;
a second active profiler raises.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import profiler as JP
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.observability import SpanTracer, bridge_record_events
from paddle_tpu_torch.serving import ServingEngine as TEngine


@pytest.mark.parametrize("skip_first", [0, 2])
@pytest.mark.parametrize("repeat", [0, 1, 2])
def test_make_scheduler_states_match_jax(repeat, skip_first):
    for closed in range(3):
        for ready in range(3):
            for record in range(1, 4):
                kw = dict(closed=closed, ready=ready, record=record,
                          repeat=repeat, skip_first=skip_first)
                j, t = JP.make_scheduler(**kw), TP.make_scheduler(**kw)
                assert [t(i).name for i in range(24)] == \
                    [j(i).name for i in range(24)], kw


def _nesting_stats(prof):
    prof.reset_host_statistics()
    for _ in range(3):
        with prof.RecordEvent("outer"):
            time.sleep(0.002)
            with prof.RecordEvent("inner"):
                time.sleep(0.002)
    st = prof.host_statistics()
    ev = prof.RecordEvent("manual")
    ev.begin()
    ev.end()
    ev.end()                              # idempotent, not double-counted
    calls = {k: v["calls"] for k, v in prof.host_statistics().items()}
    prof.reset_host_statistics()
    return st, calls, prof.host_statistics()


def test_record_event_nesting_matches_jax():
    st, calls, after = _nesting_stats(TP)
    _, jcalls, jafter = _nesting_stats(JP)
    assert calls == jcalls == {"outer": 3, "inner": 3, "manual": 1}
    assert after == jafter == {}
    assert 0 < st["inner"]["total_ms"] <= st["outer"]["total_ms"]
    assert st["outer"]["avg_ms"] == pytest.approx(
        st["outer"]["total_ms"] / 3)


def test_record_event_bridge_into_tracer():
    tr = SpanTracer()
    detach = bridge_record_events(tr)
    try:
        with TP.RecordEvent("annotated"):
            time.sleep(0.001)
    finally:
        detach()
    with TP.RecordEvent("after_detach"):
        pass
    names = [(s.name, s.track) for s in tr.spans()]
    assert ("annotated", "profiler") in names
    assert all(n != "after_detach" for n, _ in names)
    spans = [s for s in tr.spans() if s.name == "annotated"]
    assert spans[0].dur_s >= 0.001


def test_timer_only_summary_matches_jax(capsys):
    outs = []
    for prof in (JP, TP):
        prof.reset_host_statistics()
        p = prof.Profiler(timer_only=True)
        p.start()
        for _ in range(4):
            np.ones(8).sum()
            p.step()
        p.stop()
        outs.append(p.summary().splitlines())
    j, t = outs
    assert t[:2] == j[:2] == ["Profiler summary", "-" * 60]
    assert t[2].startswith("steps: 4 ") and j[2].startswith("steps: 4 ")
    assert len(t) == len(j) == 3


def test_window_trace_holds_every_thread_and_a_second_profiler_raises(
        tmp_path):
    done = threading.Event()
    go = threading.Event()

    def worker():
        while not done.is_set():
            if go.wait(0.01):
                go.clear()
                with TP.RecordEvent("worker.span"):
                    torch.ones(4).sum()

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    p = TP.Profiler(scheduler=TP.make_scheduler(closed=1, ready=1, record=2,
                                                repeat=1),
                    on_trace_ready=TP.export_chrome_tracing(str(tmp_path)))
    p.start()
    for step in range(5):
        with TP.RecordEvent("main.span"):
            go.set()
            time.sleep(0.05)
        if step == 2:
            with pytest.raises(RuntimeError):
                TP.Profiler().start()
        p.step()
    p.stop()
    done.set()
    th.join()
    assert len(p.trace_paths) == 1
    trace = json.load(open(p.trace_paths[0]))
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    # steps 2 and 3 record: two spans on each thread
    assert names.count("main.span") == 2
    assert names.count("worker.span") == 2
    tids = {e["tid"] for e in trace["traceEvents"]
            if e.get("name") == "worker.span"}
    assert tids == {th.native_id}


JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)


@pytest.mark.parametrize("block", [1, 2])
def test_engine_host_statistics_match_jax(block):
    jparams = JL.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = TL.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jparams),
                                 device="cpu")
    kw = dict(max_batch=4, page_size=4, max_prompt_len=16,
              max_new_tokens_cap=16, prefill_chunk=4,
              decode_block_size=block)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(1, TCFG.vocab_size, n).astype(np.int32), m)
            for n, m in ((5, 4), (11, 6), (3, 7))]
    calls, toks = [], []
    for prof, eng in ((JP, JEngine(jparams, JCFG, **kw)),
                      (TP, TEngine(tparams, TCFG, device="cpu", **kw))):
        prof.reset_host_statistics()
        toks.append([np.asarray(eng.generate(p, n)) for p, n in reqs])
        eng.close()
        st = prof.host_statistics()
        calls.append({k: st.get(k, {"calls": 0})["calls"]
                      for k in ("serving.tick", "serving.decode_step")})
        assert st["serving.admit"]["calls"] >= len(reqs)
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    assert calls[1] == calls[0]
    # prefill ticks, and pure-decode ticks (the fused block, 1 step or 2)
    assert calls[1]["serving.tick"] > 0 and \
        calls[1]["serving.decode_step"] > 0
