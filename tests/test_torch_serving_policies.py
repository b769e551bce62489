"""The PyTorch port's engine policies: backpressure, rejection,
cancellation, deadlines, drain, bounded skip-ahead admission and the
prefix-cache trie, carried over from tests/test_serving.py and
tests/test_prefix_cache.py. Tokens are held to the JAX package's
``generate()`` on the same weights; the scheduler and trie are driven
through the same operation sequences as the JAX package's copies and
must agree with them."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.paged_kv import PagePool as JPagePool
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import PrefixCache as JPrefixCache
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Scheduler as JScheduler
from paddle_tpu_torch.inference.paged_kv import PagePool
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import (CANCELLED, COMPLETED, TIMED_OUT,
                                      PrefixCache, Request, Scheduler,
                                      ServingEngine)

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
    out = _gen_jit(n)(jparams, jnp.asarray(prompt)[None])
    return np.asarray(out)[0, len(prompt):]


def _engine(tparams, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 16)
    return ServingEngine(tparams, TCFG, device="cpu", **kw)


def _toks(*xs):
    return np.asarray(xs, np.int32)


# ---------------------------------------------------------------------------
# engine policies
# ---------------------------------------------------------------------------

def test_page_exhaustion_backpressure(jparams, tparams):
    """A pool that funds ~1.5 worst-case slots still serves every
    request, by queuing admissions until pages free up."""
    specs = [(np.arange(1, 9, dtype=np.int32) * (i + 1) % 100, 10)
             for i in range(5)]
    with _engine(tparams, total_pages=13) as eng:
        outs = [h.result(timeout=300)
                for h in [eng.submit(p, m) for p, m in specs]]
        snap = eng.stats()
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    assert snap["histograms"]["page_utilization"]["max"] <= 1.0
    assert snap["counters"]["completed"] == 5


def test_never_fitting_request_rejected(tparams):
    with _engine(tparams, max_queue=2) as eng:
        with pytest.raises(RuntimeError, match="rejected"):
            eng.submit(np.zeros((17,), np.int32), 4)  # prompt too long
        with pytest.raises(RuntimeError, match="rejected"):
            eng.submit(np.zeros((4,), np.int32), 4000)  # page budget
        assert eng.stats()["counters"]["rejected"] == 2


def test_cancel_mid_generation_frees_slot(jparams, tparams):
    prompt = np.asarray([3, 1, 4], np.int32)
    with _engine(tparams, max_batch=1, tick_interval_s=0.05) as eng:
        h = eng.submit(prompt, 16)
        it = iter(h)
        got = [next(it), next(it)]
        h.cancel()
        rest = list(it)
        assert h.status == CANCELLED
        np.testing.assert_array_equal(
            got + rest, _ref(jparams, prompt, 16)[:len(got) + len(rest)])
        assert len(got) + len(rest) < 16
        p2 = np.asarray([7, 7], np.int32)
        np.testing.assert_array_equal(
            eng.submit(p2, 5).result(timeout=300), _ref(jparams, p2, 5))
    assert eng.pool.used_pages == 0


def test_deadline_timeout_retires(tparams):
    with _engine(tparams, max_batch=1) as eng:
        h_run = eng.submit(np.asarray([1, 2, 3], np.int32), 16)
        h_q = eng.submit(np.asarray([4, 5], np.int32), 8, timeout=0.0)
        assert len(h_run.result(timeout=300)) == 16
        assert h_q.result(timeout=300).size == 0
        assert h_q.status == TIMED_OUT


@pytest.mark.parametrize("drain", [True, False])
def test_close_drains_or_cancels(jparams, tparams, drain):
    rng = np.random.RandomState(1)
    specs = [(rng.randint(0, TCFG.vocab_size, (4,)).astype(np.int32),
              int(rng.randint(2, 8))) for _ in range(4)]
    eng = _engine(tparams, max_batch=1, tick_interval_s=0.0 if drain
                  else 0.05)
    handles = [eng.submit(p, m) for p, m in specs]
    eng.close(drain=drain)
    if drain:
        for (p, m), h in zip(specs, handles):
            assert h.status == COMPLETED
            np.testing.assert_array_equal(h.result(), _ref(jparams, p, m))
    else:
        assert all(h.status == CANCELLED for h in handles[1:])
    assert eng.pool.used_pages == 0
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(specs[0][0], 2)


def test_admission_window_engine_end_to_end(jparams, tparams):
    """A head whose budget cannot fit beside the resident does not
    convoy a small request behind it when admission_window is set, and
    every request's tokens stay exact."""
    rng = np.random.RandomState(8)
    resident = rng.randint(0, TCFG.vocab_size, (4,)).astype(np.int32)
    big = rng.randint(0, TCFG.vocab_size, (16,)).astype(np.int32)
    small = rng.randint(0, TCFG.vocab_size, (2,)).astype(np.int32)
    with _engine(tparams, max_batch=2, total_pages=13, admission_window=1,
                 prefix_cache=False, tick_interval_s=0.01) as eng:
        h_res = eng.submit(resident, 16)
        next(iter(h_res))
        h_big = eng.submit(big, 16)
        h_small = eng.submit(small, 4)
        out_small = h_small.result(timeout=300)
        assert h_big.status != COMPLETED
        out_res = h_res.result(timeout=300)
        out_big = h_big.result(timeout=300)
    np.testing.assert_array_equal(out_small, _ref(jparams, small, 4))
    np.testing.assert_array_equal(out_res, _ref(jparams, resident, 16))
    np.testing.assert_array_equal(out_big, _ref(jparams, big, 16))


# ---------------------------------------------------------------------------
# scheduler and trie, side by side with the JAX package's copies
# ---------------------------------------------------------------------------

def _window_scenario(PagePool, Scheduler, Request):
    """Admission order under admission_window=2 (bounded skip-ahead)."""
    pool = PagePool(total_pages=9, page_size=4)
    sched = Scheduler(max_batch=3, pages_per_slot=8, pool=pool,
                      admission_window=2)
    reqs = [Request(np.zeros((4,), np.int32), 16),     # 5 pages
            Request(np.zeros((8,), np.int32), 25),     # 8 pages: stuck
            Request(np.zeros((2,), np.int32), 3),
            Request(np.zeros((2,), np.int32), 3),
            Request(np.zeros((2,), np.int32), 3)]
    name = {r.id: i for i, r in enumerate(reqs)}
    log = []
    sched.submit(reqs[0])
    log.append([name[r.id] for _, r in sched.admit()])
    for r in reqs[1:]:
        assert sched.submit(r)
    a = sched.admit()
    log.append([name[r.id] for _, r in a])
    sched.retire(a[0][0], "completed")
    log.append([name[r.id] for _, r in sched.admit()])
    sched.retire(0, "completed")
    sched.retire(a[1][0], "completed")
    a3 = sched.admit()
    log.append([name[r.id] for _, r in a3])
    sched.retire(a3[0][0], "completed")
    log.append([name[r.id] for _, r in sched.admit()])
    return log


def test_admission_window_matches_jax_scheduler():
    """The stuck head is overtaken at most twice, then goes first."""
    got = _window_scenario(PagePool, Scheduler, Request)
    assert got == [[0], [2, 3], [], [1], [4]]
    assert got == _window_scenario(JPagePool, JScheduler, JRequest)


def _trie_scenario(PagePool, PrefixCache):
    """acquire / insert (with a racing duplicate) / LRU leaf-first
    eviction / pinning, returning what each step observed."""
    pool = PagePool(total_pages=16, page_size=2)
    pc = PrefixCache(pool)
    out = [len(pc.acquire(_toks(1, 2, 3, 4, 5)))]
    a = pc.insert(_toks(1, 2, 3, 4, 9), [], pool.alloc(2))[0]
    _, dup = pc.insert(_toks(1, 2, 3, 4, 9), [], pool.alloc(2))
    b = pc.insert(_toks(7, 8, 9), [], pool.alloc(1))[0]
    pool.free(dup)
    capped = pc.acquire(_toks(1, 2, 3, 4))             # capped at 1 page
    out += [len(dup), pc.cached_pages, len(capped),
            pc.match_pages(_toks(1, 2, 9, 9, 7))]
    pc.release(capped)
    pc.release(a)
    pc.release(b)
    pc.release(pc.acquire(_toks(7, 8, 5)))             # B touched: A is LRU
    out += [pc.evict(1), pc.cached_pages,
            pc.match_pages(_toks(1, 2, 5))]            # A's parent lives
    pin = pc.acquire(_toks(7, 8, 5))
    out += [pc.evict(10)]                              # B is pinned
    pc.release(pin)
    out += [pc.evict(10), pc.cached_pages, pool.free_pages]
    return out


def test_prefix_cache_trie_matches_jax():
    got = _trie_scenario(PagePool, PrefixCache)
    assert got == [0, 2, 3, 1, 1, 1, 2, 1, 1, 1, 0, 15]
    assert got == _trie_scenario(JPagePool, JPrefixCache)
    pc = PrefixCache(PagePool(total_pages=4, page_size=2))
    nodes = pc.insert(_toks(1, 2, 3), [], [1])[0]
    pc.release(nodes)
    with pytest.raises(RuntimeError, match="underflow"):
        pc.release(nodes)


def test_fruitless_eviction_preserves_prefix_cache():
    """A candidate whose shortfall cannot be met even by evicting every
    reusable page must not drain the cache; once it can, eviction runs
    and admission proceeds."""
    pool = PagePool(total_pages=9, page_size=2)
    pc = PrefixCache(pool)
    sched = Scheduler(max_batch=2, pages_per_slot=8, pool=pool,
                      prefix_cache=pc)
    holder = Request(np.zeros((2,), np.int32), 9)      # 5 pages
    assert sched.submit(holder) and len(sched.admit()) == 1
    pc.release(pc.insert(_toks(1, 2, 3, 4, 5), [], pool.alloc(2))[0])
    big = Request(np.zeros((4,), np.int32), 5)         # needs 4 pages
    assert sched.submit(big)
    assert sched.admit() == []
    assert pc.cached_pages == 2
    sched.drop_queued(lambda r: r is big)
    ok = Request(np.zeros((2,), np.int32), 5)          # needs 3 pages
    assert sched.submit(ok)
    assert [r.id for _, r in sched.admit()] == [ok.id]
    assert pc.cached_pages == 0 and pc.evictions == 2
