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
    """The stream retires at the first EOS; sampling, an over-long
    prompt and a closed engine are refused."""
    prompt = np.asarray([5, 9, 2, 11], np.int32)
    full = _ref(jparams, prompt, 8)
    eos = int(full[3])
    want = full[:int(np.argmax(full == eos)) + 1]
    eng = _engine(tparams)
    h = eng.submit(prompt, 8, eos_token_id=eos)
    np.testing.assert_array_equal(list(h), want)
    assert h.status == COMPLETED
    with pytest.raises(NotImplementedError, match="later slice"):
        eng.submit(prompt, 4, temperature=0.7)
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
