"""PyTorch port of the continuous-batching engine vs the JAX package.

Correctness bar, carried over from tests/test_serving.py: with greedy
decoding every request's tokens equal a standalone ``generate()`` run
token for token — here the JAX package's ``generate()`` on the same
weights — whatever else shares the batch: staggered arrivals, chunked
prefill, warm prefix-cache attaches, fused decode blocks.
"""
import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.paged_kv import PagePool as JaxPagePool
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference.paged_kv import PagePool
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import COMPLETED, ServingEngine

JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


@functools.lru_cache(maxsize=None)
def _gen_jit(n):
    return jax.jit(lambda p, t: JL.generate(p, t, JCFG, max_new_tokens=n))


def _ref(jparams, prompt, n):
    """JAX generate() continuation (prompt stripped)."""
    out = _gen_jit(n)(jparams, jnp.asarray(prompt)[None])
    return np.asarray(out)[0, len(prompt):]


def _engine(tparams, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 16)
    return ServingEngine(tparams, TCFG, device="cpu", **kw)


def test_mixed_staggered_arrivals_match_jax_generate(jparams, tparams):
    """Mixed prompt lengths and max_new_tokens, staggered arrivals, more
    requests than slots: every continuation equals JAX generate()."""
    rng = np.random.RandomState(0)
    lens, mnts = (3, 7, 12), (3, 8)
    specs = [(rng.randint(0, TCFG.vocab_size,
                          (int(rng.choice(lens)),)).astype(np.int32),
              int(rng.choice(mnts))) for _ in range(8)]
    with _engine(tparams) as eng:
        handles = []
        for prompt, mnt in specs:
            handles.append(eng.submit(prompt, mnt))
            time.sleep(float(rng.exponential(0.003)))
        outs = [h.result(timeout=300) for h in handles]
    for (prompt, mnt), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, prompt, mnt))
    snap = eng.stats()
    assert snap["counters"]["completed"] == len(specs)
    # continuous batching happened: fewer decode steps than the sum
    assert 0 < snap["counters"]["decode_steps"] < sum(m - 1
                                                      for _, m in specs)
    assert snap["gauges"]["free_pages"] == eng.pool.total_pages - 1


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_prefill_matches_jax_generate(jparams, tparams, chunk):
    """prefill_chunk below the prompt length is a scheduling knob only,
    for aligned and unaligned chunk sizes."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, TCFG.vocab_size, (n,)).astype(np.int32)
               for n in (15, 9, 13)]
    with _engine(tparams, prefill_chunk=chunk) as eng:
        outs = [h.result(timeout=300)
                for h in [eng.submit(p, 5) for p in prompts]]
        chunks = eng.stats()["counters"]["prefill_chunks"]
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, 5))
    assert chunks >= sum(-(-len(p) // chunk) for p in prompts)


def test_warm_prefix_attach_matches_jax_generate(jparams, tparams):
    """Cold, fully cached and partially cached prefixes give the same
    tokens as JAX generate(), and the warm runs attached pages."""
    rng = np.random.RandomState(2)
    base = rng.randint(0, TCFG.vocab_size, (13,)).astype(np.int32)
    partial = np.concatenate(
        [base[:9], rng.randint(0, TCFG.vocab_size, (5,)).astype(np.int32)])
    with _engine(tparams) as eng:
        cold = eng.submit(base, 6).result(timeout=300)
        warm = eng.submit(base, 6).result(timeout=300)
        part = eng.submit(partial, 6).result(timeout=300)
        snap = eng.stats()
    np.testing.assert_array_equal(cold, _ref(jparams, base, 6))
    np.testing.assert_array_equal(warm, _ref(jparams, base, 6))
    np.testing.assert_array_equal(part, _ref(jparams, partial, 6))
    assert snap["counters"]["prefix_hits"] >= 2
    assert snap["counters"]["prefix_hit_tokens"] > 0


def test_decode_block_matches_jax_generate(jparams, tparams):
    """decode_block_size=3: fused decode blocks and admission-tick tails
    (including a max_new_tokens that is not a multiple of the block)."""
    rng = np.random.RandomState(6)
    specs = [(rng.randint(0, TCFG.vocab_size, (n,)).astype(np.int32), m)
             for n, m in ((5, 8), (11, 3), (7, 8), (3, 8))]
    with _engine(tparams, decode_block_size=3) as eng:
        handles = [eng.submit(p, m) for p, m in specs]
        outs = [h.result(timeout=300) for h in handles]
        steps = eng.stats()["counters"]
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    assert steps["model_steps"] >= steps["decode_steps"] > 0


def test_streaming_eos_and_rejections(jparams, tparams):
    """The stream retires at the first EOS; a sampled request is
    served; an over-long prompt and a closed engine are refused."""
    prompt = np.asarray([5, 9, 2, 11], np.int32)
    full = _ref(jparams, prompt, 8)
    eos = int(full[3])
    want = full[:int(np.argmax(full == eos)) + 1]
    eng = _engine(tparams)
    h = eng.submit(prompt, 8, eos_token_id=eos)
    np.testing.assert_array_equal(list(h), want)
    assert h.status == COMPLETED
    out = eng.submit(prompt, 4, temperature=0.7, seed=3).result(timeout=300)
    assert out.shape == (4,) and ((out >= 0) & (out < TCFG.vocab_size)).all()
    with pytest.raises(RuntimeError, match="rejected"):
        eng.submit(np.arange(17, dtype=np.int32), 4)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(prompt, 4)


def test_engine_rejects_params_on_another_device(tparams):
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(tparams, TCFG, device="meta", max_prompt_len=8,
                      max_new_tokens_cap=8)


def test_page_pool_matches_jax_page_pool():
    """The copied allocator hands out, frees and plans defrag exactly as
    the JAX package's does."""
    ops = [("alloc", 3), ("alloc", 2), ("free", [2, 4]), ("alloc", 1),
           ("alloc", 3), ("free", [1, 6])]
    pools = [PagePool(10, 4), JaxPagePool(10, 4)]
    for op, arg in ops:
        got = [getattr(p, op)(arg) for p in pools]
        assert got[0] == got[1]
    assert pools[0].defrag_plan() == pools[1].defrag_plan()
    for p in pools:
        p.commit_defrag(p.defrag_plan())
    assert pools[0].free_page_ids == pools[1].free_page_ids
    page = pools[0].alloc(1)
    pools[0].free(page)
    with pytest.raises(ValueError, match="double free"):
        pools[0].free(page)


def test_defragment_mid_generation_is_invisible(jparams, tparams):
    """Defrags between ticks while requests decode, prefill in chunks
    and sit parked: every continuation still equals JAX generate(), and
    pages did move."""
    rng = np.random.RandomState(8)
    specs = [(rng.randint(0, TCFG.vocab_size, (n,)).astype(np.int32), m)
             for n, m in ((5, 3), (15, 12), (9, 14), (3, 2), (13, 10),
                          (6, 9))]
    moved = 0
    with _engine(tparams, prefill_chunk=3, max_batch=3) as eng:
        handles = []
        for p, m in specs:
            handles.append(eng.submit(p, m))
            moved += eng.defragment()
        while not all(h._req.done.is_set() for h in handles):
            moved += eng.defragment()
            time.sleep(0.001)
        outs = [h.result(timeout=300) for h in handles]
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    assert moved > 0
    # closed: the cached pages went back too, and the pool balances
    assert eng.pool.free_pages == eng.pool.total_pages - 1


def test_remap_pages_and_prefix_cache_remap():
    """A defrag plan reaches the requests' page lists, a parked
    request's stashed row and the cached pages; the scheduler's own
    table rows are apply_defrag's to rewrite, never remapped twice."""
    from paddle_tpu_torch.serving import PrefixCache, Request, Scheduler
    pool = PagePool(12, 4)
    cache = PrefixCache(pool)
    sch = Scheduler(max_batch=2, pages_per_slot=3, pool=pool,
                    prefix_cache=cache)
    pool.alloc(2)                   # pages 1, 2: freed below, a hole
    a, b = Request(np.arange(9), 3), Request(np.arange(20, 25), 4)
    for r in (a, b):
        sch.submit(r)
    sch.admit()
    adopted, _ = cache.insert(a.prompt, [], a.pages[:2])
    a.prefix_nodes, a.pages = adopted, a.pages[2:]
    b.table_row = sch.tables[1].copy()      # parked mid-prefill
    sch.tables[1, :] = PagePool.TRASH
    pool.free([1, 2])
    plan = pool.defrag_plan()
    assert plan == {3: 1, 4: 2, 5: 3, 6: 4, 7: 5}
    rows = sch.tables.copy()
    sch.remap_pages(plan)
    cache.remap(plan)
    np.testing.assert_array_equal(sch.tables, rows)
    assert [nd.page for nd in a.prefix_nodes] == [1, 2]
    assert a.pages == [3] and b.pages == [4, 5]
    np.testing.assert_array_equal(b.table_row, [4, 5, 0])


def _filled_metrics(mod):
    """One set of counter, labeled and histogram values in a
    ``ServingMetrics`` of ``mod``; the port's engine-only counters are
    set on the JAX one too, so both hold the same values."""
    m = mod.ServingMetrics()
    for name in ("ticks", "model_steps"):
        m.counters.setdefault(name, 0)
    for i, name in enumerate(sorted(m.counters)):
        m.counters[name] = 3 * i
    m.inc_labeled("recompiles", 2, during='serving.tick "a"\\b')
    m.inc_labeled("recompiles", during="line\nbreak")
    for i, name in enumerate(sorted(m.histograms)):
        for v in np.linspace(0.001 * (i + 1), 0.5, 7 + i):
            m.observe(name, float(v))
    return m


def test_expose_and_merge_exposition_match_jax():
    """``expose`` and ``merge_exposition`` render the same bytes as the
    JAX package's for the same values: escaping, gauge renaming, label
    stamping, a remote text entry parsed back."""
    from paddle_tpu.serving import metrics as JM
    from paddle_tpu_torch.serving import metrics as TM
    tm, jm = _filled_metrics(TM), _filled_metrics(JM)
    assert set(tm.counters) == set(jm.counters)
    assert set(tm.histograms) == set(jm.histograms)
    gauges = {"queued": 2, "page_utilization": 0.25, "free_pages": 17}
    labels = {"replica": 'r"0\\\n'}
    got = tm.expose(gauges=gauges, labels=labels)
    assert got == jm.expose(gauges=gauges, labels=labels)
    assert "paddle_serving_page_utilization_now" in got
    entries = [({"replica": "a"}, tm, gauges), ({"replica": "b"}, got, None),
               ({}, None, {"extra": 1.5})]
    jentries = [({"replica": "a"}, jm, gauges), ({"replica": "b"}, got, None),
                ({}, None, {"extra": 1.5})]
    merged = TM.merge_exposition(entries)
    assert merged == JM.merge_exposition(jentries)
    assert TM.merge_exposition([({}, got, None)]) == got
    assert TM._parse_exposition(merged, "paddle_serving") == \
        JM._parse_exposition(merged, "paddle_serving")


def test_engine_expose_parses_back(tparams):
    """The engine's scrape carries its counters and gauges and parses
    back through ``_parse_exposition``."""
    from paddle_tpu_torch.serving.metrics import _parse_exposition
    with _engine(tparams) as eng:
        eng.submit(np.asarray([3, 1, 4, 1, 5], np.int32), 4).result(
            timeout=300)
        text = eng.expose(labels={"replica": "r0"})
        gauges = eng.gauges()
    fam = _parse_exposition(text, "paddle_serving")
    assert fam["counters"]["tokens_out"] == [({"replica": "r0"}, 4)]
    assert fam["counters"]["completed"] == [({"replica": "r0"}, 1)]
    assert fam["counters"]["spec_ticks"] == [({"replica": "r0"}, 0)]
    assert fam["gauges"]["free_pages"] == [({"replica": "r0"},
                                            gauges["free_pages"])]
    assert "prefix_cache_cached_pages" in fam["gauges"]
    assert fam["summaries"]["ttft_s"][0][1]["count"] == 1
