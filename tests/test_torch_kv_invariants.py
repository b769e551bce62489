"""The paged-KV invariant audit of the PyTorch port's serving engine, held
against the JAX checker (the counterparts of tests/test_analysis.py's
checker tests).

A healthy engine audits clean through a mixed workload; each seeded
corruption (a leaked reference, a double-attached page, a live page on
the free list, a real entry in a parked slot's row, a stale defrag plan)
is caught with the violation codes the JAX checker reports on the same
corrupted state; live corruption fails the engine; a defrag while a
chunked prefill is parked stays clean and exact.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.analysis import kv_invariants as jkv
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.analysis import (KVInvariantError, audit_defrag_plan,
                                       audit_serving_state)
from paddle_tpu_torch.inference.paged_kv import PagePool
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingEngine

JCFG = dataclasses.replace(
    JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                        remat=False), num_hidden_layers=2)
TCFG = dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32),
                           num_hidden_layers=2)


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
    out = _gen_jit(n)(jparams, jnp.asarray(prompt)[None])
    return np.asarray(out)[0, len(prompt):]


def _eng(tparams, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 16)
    kw.setdefault("check_invariants", True)
    return ServingEngine(tparams, TCFG, device="cpu", **kw)


def _codes(eng):
    """The port's and the JAX checker's violation codes on the engine's
    current state (caller holds the tick lock)."""
    args = (eng.pool, eng.scheduler, eng.prefix_cache)
    return ({v.code for v in audit_serving_state(*args)},
            {v.code for v in jkv.audit_serving_state(*args)})


def test_per_tick_audit_follows_the_environment(tparams, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_CHECK_INVARIANTS", "1")
    with _eng(tparams, check_invariants=None) as on:
        assert on._check_invariants
    monkeypatch.setenv("PADDLE_TPU_SERVING_CHECK_INVARIANTS", "0")
    with _eng(tparams, check_invariants=None) as off:
        assert not off._check_invariants


def test_checker_clean_through_mixed_workload(tparams):
    rng = np.random.RandomState(0)
    with _eng(tparams, prefill_chunk=4) as eng:
        hs = [eng.submit(rng.randint(0, 256, (n,)).astype(np.int32), 5)
              for n in (12, 3, 15, 12, 7)]
        for h in hs:
            h.result(timeout=300)
        assert eng.audit() == []
        with eng._tick_lock:
            assert _codes(eng) == (set(), set())
        assert eng.snapshot()["counters"]["invariant_violations"] == 0
    assert eng.pool.used_pages == 0


def test_checker_catches_refcount_corruption(tparams):
    prompt = np.arange(1, 13, dtype=np.int32)
    with _eng(tparams) as eng:
        eng.submit(prompt, 4).result(timeout=300)
        with eng._tick_lock:
            nodes = eng.prefix_cache.nodes()
            assert nodes
            nodes[0].refs += 1          # seeded bug: leaked reference
            got, want = _codes(eng)
            nodes[0].refs -= 1
        assert "refcount-drift" in got and got == want
        assert eng.audit() == []


def test_checker_catches_double_attached_page(tparams):
    """One physical page in two live slots' rows without a backing trie
    refcount."""
    rng = np.random.RandomState(1)
    p1 = rng.randint(0, 256, (6,)).astype(np.int32)
    p2 = rng.randint(0, 256, (6,)).astype(np.int32)
    eng = _eng(tparams, check_invariants=False, tick_interval_s=0.01)
    try:
        h1 = eng.submit(p1, 12)
        h2 = eng.submit(p2, 12)
        next(iter(h1))
        next(iter(h2))              # both slots live
        with eng._tick_lock:
            (s1, _), (_, r2) = eng.scheduler.occupied()
            eng.scheduler.tables[s1, -1] = r2.pages[0]
            got, want = _codes(eng)
            eng.scheduler.tables[s1, -1] = PagePool.TRASH
        assert got & {"share-uncached", "row-mismatch"}
        assert got == want
    finally:
        eng.close(drain=False)


def test_checker_catches_freelist_aliasing(tparams):
    prompt = np.arange(1, 9, dtype=np.int32)
    eng = _eng(tparams, check_invariants=False, tick_interval_s=0.01)
    try:
        h = eng.submit(prompt, 12)
        next(iter(h))
        with eng._tick_lock:
            (_, req), = eng.scheduler.occupied()
            page = req.pages[0]
            # seeded bug: a live page pushed back to the free list
            eng.pool._free.append(page)
            eng.pool._free_set.add(page)
            got, want = _codes(eng)
            eng.pool._free.remove(page)
            eng.pool._free_set.discard(page)
        assert "page-free-owned" in got and got == want
    finally:
        eng.close(drain=False)


def test_checker_catches_parked_row_leak(tparams):
    """A parked (mid chunked-prefill) slot whose scheduler row is not
    all-TRASH."""
    rng = np.random.RandomState(2)
    long_p = rng.randint(0, 256, (16,)).astype(np.int32)
    short_p = rng.randint(0, 256, (2,)).astype(np.int32)
    eng = _eng(tparams, prefill_chunk=4, max_batch=2,
               check_invariants=False, tick_interval_s=0.02)
    try:
        h_short = eng.submit(short_p, 24)
        next(iter(h_short))
        h_long = eng.submit(long_p, 4)
        seen = False
        for _ in range(400):
            time.sleep(0.002)
            with eng._tick_lock:
                parked = [(s, r) for s, r in eng.scheduler.occupied()
                          if r.table_row is not None]
                if parked:
                    seen = True
                    slot, req = parked[0]
                    assert _codes(eng) == (set(), set())
                    eng.scheduler.tables[slot, 0] = req.table_row[0]
                    got, want = _codes(eng)
                    eng.scheduler.tables[slot, 0] = PagePool.TRASH
                    break
            if h_long._req.done.is_set():
                break
        assert seen, "no parked slot observed"
        assert "parked-row-live" in got and got == want
        h_long.result(timeout=300)
        h_short.result(timeout=300)
    finally:
        eng.close()


def test_defrag_plan_audit_catches_stale_mapping(tparams):
    prompt = np.arange(1, 13, dtype=np.int32)
    with _eng(tparams) as eng:
        eng.submit(prompt, 4).result(timeout=300)
        with eng._tick_lock:
            args = (eng.pool, eng.scheduler, eng.prefix_cache)
            plan = eng.pool.defrag_plan()
            assert audit_defrag_plan(plan, *args) == []
            stale = dict(plan)
            stale[max(eng.pool.free_page_ids)] = 1
            got = {v.code for v in audit_defrag_plan(stale, *args)}
            want = {v.code for v in jkv.audit_defrag_plan(stale, *args)}
        assert "defrag-stale-src" in got and got == want


def test_per_tick_checker_fails_engine_on_live_corruption(tparams):
    """Corrupt state under the tick lock: the next tick's audit kills
    the engine through its fail path, surfacing KVInvariantError (with
    the engine's geometry) to every caller."""
    rng = np.random.RandomState(3)
    eng = _eng(tparams, tick_interval_s=0.01)
    try:
        eng.submit(rng.randint(0, 256, (9,)).astype(np.int32), 4) \
           .result(timeout=300)
        h = eng.submit(rng.randint(0, 256, (9,)).astype(np.int32), 24)
        next(iter(h))
        with eng._tick_lock:
            nodes = eng.prefix_cache.nodes()
            assert nodes
            nodes[0].refs += 3      # corruption the next tick must see
        with pytest.raises(KVInvariantError) as exc:
            h.result(timeout=300)
        assert "engine geometry:" in str(exc.value)
        assert "page_size=" in str(exc.value)
        assert any(v.code == "refcount-drift" for v in exc.value.violations)
        eng._worker.join(timeout=60)
        assert not eng.alive
        c = eng.snapshot()["counters"]
        assert c["invariant_violations"] >= 1
        with pytest.raises(RuntimeError, match="died"):
            eng.submit(np.arange(1, 4, dtype=np.int32), 2)
        assert eng.inject(h._req) is False
        assert eng.snapshot()["counters"]["rejected"] == c["rejected"] + 1
    finally:
        eng.close(drain=False)


def test_defrag_while_chunk_prefill_parked(jparams, tparams):
    """A defrag while a slot is parked mid chunked-prefill remaps the
    stashed row, the live rows and the cached pages consistently: the
    audits of the plan and of the state after it pass, and every
    request still equals JAX generate()."""
    rng = np.random.RandomState(4)
    churn = rng.randint(0, 256, (10,)).astype(np.int32)
    long_p = rng.randint(0, 256, (16,)).astype(np.int32)
    short_p = rng.randint(0, 256, (2,)).astype(np.int32)
    eng = _eng(tparams, prefill_chunk=4, max_batch=3,
               tick_interval_s=0.02)
    try:
        h_churn = eng.submit(churn, 2)
        h_short = eng.submit(short_p, 30)
        h_long = eng.submit(long_p, 6)
        moved = None
        for _ in range(800):
            time.sleep(0.002)
            with eng._tick_lock:
                parked = [r for _, r in eng.scheduler.occupied()
                          if r.table_row is not None]
                fragmented = (h_churn._req.done.is_set()
                              and bool(eng.pool.defrag_plan()))
            if parked and fragmented:
                moved = eng.defragment()   # audits plan + result
                break
            if h_long._req.done.is_set():
                break
        assert moved is not None, \
            "never saw a parked slot + fragmentation window"
        assert moved > 0
        out_long = h_long.result(timeout=300)
        out_short = h_short.result(timeout=300)
        assert eng.audit() == []
    finally:
        eng.close()
    np.testing.assert_array_equal(out_long, _ref(jparams, long_p, 6))
    np.testing.assert_array_equal(out_short, _ref(jparams, short_p, 30))
