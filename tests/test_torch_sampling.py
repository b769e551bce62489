"""Sampling in the PyTorch port vs the JAX package.

``paddle_tpu_torch.prng`` (threefry-2x32 on int64 tensors) against
``jax.random``; the samplers ``sample_logits`` / ``_fused_sample``
against JAX's on the same logits and keys; sampled ``generate`` /
``generate_paged``, the sampled serving tick (plain, decode tail and
speculative verify) and the engine's fixed-seed streams against the JAX
package's. Weights come from the JAX init through ``params_from_jax``;
inputs are seeded numpy arrays handed to both.

Contract: keys, ``fold_in``, ``split``, bits and uniforms bitwise;
Gumbel noise within 2e-6 absolute (the f32 logs of two libraries);
sampled tokens equal wherever the top two perturbed logits differ by
more than 1e-5, and the seeds used have no row under that margin (the
test counts them). Inside the port, a fixed-seed sampled stream is one
stream alone, beside neighbours, under decode blocks 1 and 4 and on a
speculative engine, and an all-greedy tick launches nothing of the
sampler.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import prng
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingEngine

JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)
SEEDS = (0, 7, -3, 2 ** 40 + 5)
MARGIN = 1e-5       # top-two perturbed logits closer than this may differ
GUMBEL_ATOL = 2e-6


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# ---------------------------------------------------------------------------
# (i) the PRNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_jax_random(seed):
    """key, fold_in, split, bits and uniform bitwise; gumbel within
    2e-6 absolute; shapes (V,) and (B, V)."""
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    idx = [0, 1, 37, 2 ** 31 + 3]
    got = prng.fold_in(tk.expand(len(idx), 2), torch.tensor(idx))
    want = np.stack([_u32(jax.random.fold_in(jk, n)) for n in idx])
    np.testing.assert_array_equal(got.numpy(), want)
    for n in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _u32(jax.random.split(jk, n)))
    for shape in ((1000,), (3, 1000)):
        np.testing.assert_array_equal(
            prng.bits(tk, shape).numpy(),
            _u32(jax.random.bits(jk, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            prng.uniform(tk, shape).numpy(),
            np.asarray(jax.random.uniform(jk, shape)))
        np.testing.assert_allclose(prng.gumbel(tk, shape).numpy(),
                                   np.asarray(jax.random.gumbel(jk, shape)),
                                   rtol=0, atol=GUMBEL_ATOL)
    # per-row keys draw each row's noise from its own key (a vmap)
    rows = prng.bits(got, (1000,)).numpy()
    for r, n in enumerate(idx):
        np.testing.assert_array_equal(
            rows[r], _u32(jax.random.bits(jax.random.fold_in(jk, n),
                                          (1000,), jnp.uint32)))


# ---------------------------------------------------------------------------
# (ii) the samplers
# ---------------------------------------------------------------------------

V = 1000
GRID = list(itertools.product((0, 1, 5, V + 10), (0.0, 0.3, 0.9, 1.0)))


def _margin(perturbed: torch.Tensor) -> torch.Tensor:
    top = perturbed.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_sample_logits_matches_jax(temp):
    """``sample_logits`` over top_k {0, 1, 5, V+10} x top_p {0, 0.3,
    0.9, 1.0}: one key draws over the whole [6, 1000] batch."""
    rng = np.random.RandomState(int(temp * 10))
    close = 0
    for top_k, top_p in GRID:
        logits = (rng.randn(6, V) * 3).astype(np.float32)
        seed = int(rng.randint(1 << 30))
        want = np.asarray(JL.sample_logits(
            jnp.asarray(logits), jax.random.PRNGKey(seed), temp, top_p,
            top_k))
        tl = torch.from_numpy(logits)
        got = TL.sample_logits(tl, prng.key(seed), temp, top_p, top_k)
        assert got.dtype == torch.int32 and got.shape == (6,)
        if temp:
            pert = (TL._sample_mask(tl, temp, top_p, top_k)
                    + prng.gumbel(prng.key(seed), tl.shape))
            sure = _margin(pert) > MARGIN
            close += int((~sure).sum())
        else:
            sure = torch.ones(6, dtype=torch.bool)
        np.testing.assert_array_equal(got.numpy()[sure.numpy()],
                                      want[sure.numpy()],
                                      err_msg=f"{top_k} {top_p}")
    assert close == 0


@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_fused_sample_matches_jax(temp):
    """``_fused_sample`` with per-row keys and indices, half the rows
    greedy: greedy rows bitwise the argmax, sampled rows JAX's draw."""
    rng = np.random.RandomState(100 + int(temp * 10))
    close = 0
    for top_k, top_p in GRID:
        logits = (rng.randn(6, V) * 3).astype(np.float32)
        temps = np.asarray([temp, 0, temp, temp, 0, temp], np.float32)
        tp = np.full((6,), top_p, np.float32)
        tk = np.full((6,), top_k, np.int32)
        keys = np.stack([np.asarray(jax.random.PRNGKey(int(s)))
                         for s in rng.randint(-1 << 30, 1 << 30, 6)])
        idx = rng.randint(0, 1 << 20, 6).astype(np.int32)
        want = np.asarray(JL._fused_sample(
            *map(jnp.asarray, (logits, temps, tp, tk, keys, idx))))
        t = [torch.from_numpy(a) for a in (logits, temps, tp, tk,
                                           keys.astype(np.int64), idx)]
        got = TL._fused_sample(*t)
        assert got.dtype == torch.int32
        greedy = temps <= 0
        np.testing.assert_array_equal(got.numpy()[greedy],
                                      logits.argmax(-1)[greedy])
        pert = (TL._draw_mask(*t[:4])
                + prng.gumbel(prng.fold_in(t[4], t[5]), (V,)))
        sure = (_margin(pert) > MARGIN).numpy() | greedy
        close += int((~sure).sum())
        np.testing.assert_array_equal(got.numpy()[sure], want[sure],
                                      err_msg=f"{top_k} {top_p}")
    assert close == 0


def test_degenerate_filters_are_the_argmax():
    """top_k 1 and top_p 0 leave only the argmax, whatever the key."""
    rng = np.random.RandomState(5)
    logits = torch.from_numpy((rng.randn(4, V) * 3).astype(np.float32))
    ones = torch.ones(4)
    for top_p, top_k in ((1.0, 1), (0.0, 0)):
        got = TL._fused_sample(
            logits, 0.8 * ones, top_p * ones,
            torch.full((4,), top_k, dtype=torch.int32),
            prng.split(prng.key(3), 4), torch.arange(4))
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))
        got = TL.sample_logits(logits, prng.key(9), 0.8, top_p, top_k)
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


# ---------------------------------------------------------------------------
# (iii) sampled generate / generate_paged
# ---------------------------------------------------------------------------

SAMP = dict(temperature=0.8, top_p=0.9, top_k=40)


@functools.lru_cache(maxsize=None)
def _jax_generate(n):
    return jax.jit(lambda p, t, k: JL.generate(
        p, t, JCFG, max_new_tokens=n, key=k, **SAMP))


def test_sampled_generate_matches_jax(jparams, tparams):
    """The split chain of ``generate``: the port's sampled tokens equal
    JAX's for one key, and a greedy decode ignores the key."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(_jax_generate(8)(jparams, jnp.asarray(prompt),
                                       jax.random.PRNGKey(11)))
    got = TL.generate(tparams, prompt, TCFG, 8, key=prng.key(11), **SAMP)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TL.generate(tparams, prompt, TCFG, 4, key=prng.key(11)).numpy(),
        TL.generate(tparams, prompt, TCFG, 4).numpy())


def test_sampled_generate_paged_matches_jax(jparams, tparams):
    """Ragged prompts through the paged cache, sampled from one key."""
    lens = [5, 9, 12]
    rng = np.random.RandomState(12)
    prompt = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        prompt[i, :n] = rng.randint(0, JCFG.vocab_size, n)
    want = JL.generate_paged(jparams, jnp.asarray(prompt),
                             jnp.asarray(lens, jnp.int32), JCFG, 6,
                             page_size=4, key=jax.random.PRNGKey(4), **SAMP)
    got = TL.generate_paged(tparams, prompt, np.asarray(lens), TCFG, 6,
                            page_size=4, key=prng.key(4), **SAMP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generation_predictor_matches_jax(jparams, tparams):
    """Both ``GenerationPredictor`` entry points sample from
    ``key(seed)`` as the JAX predictor does."""
    from paddle_tpu.inference import GenerationPredictor as JPredictor
    from paddle_tpu_torch.inference import GenerationPredictor
    prompts = [np.arange(5) % JCFG.vocab_size,
               (np.arange(11) * 7) % JCFG.vocab_size]
    jp = JPredictor(jparams, JCFG, max_len=64)
    tp = GenerationPredictor(tparams, TCFG, max_len=64, device="cpu")
    kw = dict(temperature=0.9, top_p=0.8, seed=-3)
    for a, b in zip(tp.generate_ragged(prompts, 5, page_size=4, **kw),
                    jp.generate_ragged(prompts, 5, page_size=4, **kw)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp.generate(prompts[1][None], 4, **kw),
                                  jp.generate(prompts[1][None], 4, **kw))


# ---------------------------------------------------------------------------
# the sampled serving tick
# ---------------------------------------------------------------------------

def _tick_state(seed=0, S=4, ps=4, pps=6):
    rng = np.random.RandomState(seed)
    L, Hkv, Dh = JCFG.num_hidden_layers, JCFG.num_key_value_heads, \
        JCFG.head_dim
    P = 1 + S * pps
    kp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    tables = (1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32)
    samp = dict(temp=np.asarray([0.9, 0.0, 0.7, 1.1], np.float32),
                top_p=np.asarray([0.95, 1.0, 0.5, 1.0], np.float32),
                top_k=np.asarray([0, 0, 30, 7], np.int32),
                key=np.stack([np.asarray(jax.random.PRNGKey(s))
                              for s in (42, 0, -3, 2 ** 40 + 5)]),
                produced=np.asarray([3, 0, 11, 6], np.int32))
    return rng, kp, vp, tables, samp


def _run_both(jparams, tparams, tok, meta, kp, vp, **kw):
    jmeta = {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor)
                            else v) for k, v in meta.items()}
    jout = JL.serving_tick(jparams, jnp.asarray(tok.numpy()), jmeta,
                           jnp.asarray(kp), jnp.asarray(vp), JCFG, **kw)
    tmeta = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        v.astype(np.int64) if k == "key" else v)) for k, v in meta.items()}
    kw.pop("tq", None)
    tout = TL.serving_tick(tparams, tok, tmeta, torch.from_numpy(kp.copy()),
                           torch.from_numpy(vp.copy()), TCFG, **kw)
    return jout, tout


def test_sampled_tick_with_tail_matches_jax(jparams, tparams):
    """A mixed tick (decode rows and a prompt span) with a decode tail
    of 2: every slot's picks equal JAX's, tail step j drawing index
    produced + 1 + j."""
    rng, kp, vp, tables, samp = _tick_state(1)
    tok, meta = TL.pack_tick(
        [(0, 5, 7), (1, 9, 3), (3, 2, 12)],
        [(2, rng.randint(0, 256, 6).astype(np.int32), 4)], tables, 4,
        "cpu")
    meta.update(tail_live=torch.ones(4, dtype=torch.bool), **samp)
    (jt, jl, _, _), (tt, tl, _, _) = _run_both(
        jparams, tparams, tok, meta, kp, vp, tq=6, decode_tail=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("sampled", [False, True])
def test_verify_tick_matches_jax(jparams, tparams, sampled):
    """The speculative verify pass (spec_k 3): slot 0 drafts 3 tokens,
    slot 2 drafts 1, slot 1 decodes plainly, slot 3 prefills; picks at
    every span position, acceptance and row-0 logits (the ones JAX
    returns; the port returns every verify position's) equal JAX's."""
    rng, kp, vp, tables, samp = _tick_state(2)
    tok, meta = TL.pack_tick(
        [(1, 9, 3)], [(3, rng.randint(0, 256, 5).astype(np.int32), 0)],
        tables, 4, "cpu", spec_k=3,
        drafts=[(0, 5, 7, np.asarray([5, 9, 2], np.int32)),
                (2, 4, 10, np.asarray([17], np.int32))])
    np.testing.assert_array_equal(meta["draft_len"].numpy(), [3, 0, 1, 0])
    np.testing.assert_array_equal(meta["ver_idx"].numpy()[[1, 3]],
                                  [[1] * 4, [14] * 4])
    if sampled:
        meta.update(samp)
    (jt, ja, jl, _, _), (tt, ta, tl, _, _) = _run_both(
        jparams, tparams, tok, meta, kp, vp, tq=5, spec_k=3)
    assert tl.shape == (4, 4, TCFG.vocab_size)
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TL.serving_tick(tparams, tok, meta, torch.zeros(1), torch.zeros(1),
                        TCFG, decode_tail=1, spec_k=3)


def test_all_greedy_tick_launches_no_sampler(tparams):
    """The host flag: a tick whose requests are all greedy never enters
    the draw (its counter stays put); one sampled request does."""
    eng = ServingEngine(tparams, TCFG, device="cpu", max_batch=4,
                        page_size=4, max_prompt_len=16,
                        max_new_tokens_cap=16, decode_block_size=2)
    n0 = TL.sample_draw.launches
    for h in [eng.submit(np.arange(3, 3 + n, dtype=np.int32), 5)
              for n in (4, 7, 11)]:
        h.result(timeout=300)
    assert TL.sample_draw.launches == n0
    eng.submit(np.arange(2, 9, dtype=np.int32), 5, temperature=0.8,
               seed=1).result(timeout=300)
    eng.close()
    assert TL.sample_draw.launches > n0


# ---------------------------------------------------------------------------
# (vi) fixed-seed streams through the engine
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(3)
PROMPT = RNG.randint(0, TCFG.vocab_size, (11,)).astype(np.int32)
NEIGHBOURS = [RNG.randint(0, TCFG.vocab_size, (7,)).astype(np.int32)
              for _ in range(3)]
STREAM = dict(temperature=0.9, top_p=0.95, top_k=50, seed=42)


def _engine_kw(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 16)
    return kw


def _sampled_stream(tparams, *, neighbours=0, order=0, **kw):
    """The fixed-seed request's 8 tokens, submitted ``order``-th among
    ``neighbours`` greedy requests; the neighbours' tokens too."""
    with ServingEngine(tparams, TCFG, device="cpu", **_engine_kw(**kw)) \
            as eng:
        handles, mine = [], None
        for i in range(neighbours + 1):
            if i == order:
                mine = eng.submit(PROMPT, 8, **STREAM)
            else:
                handles.append(eng.submit(NEIGHBOURS[len(handles)], 6))
        out = mine.result(timeout=300)
        nb = [h.result(timeout=300) for h in handles]
    return out, nb


@pytest.fixture(scope="module")
def jax_stream(jparams):
    with JaxEngine(jparams, JCFG, **_engine_kw()) as eng:
        return eng.submit(PROMPT, 8, **STREAM).result(timeout=300)


@pytest.mark.parametrize("case", [
    dict(), dict(neighbours=3), dict(neighbours=3, order=2),
    dict(decode_block_size=4), dict(neighbours=2, order=1,
                                    decode_block_size=4),
    dict(speculative="ngram", spec_k=3),
    dict(speculative="ngram", spec_k=3, neighbours=2, order=1)],
    ids=["alone", "neighbours", "last", "block4", "neighbours_block4",
         "spec", "spec_neighbours"])
def test_sampled_stream_is_one_stream(tparams, jax_stream, case):
    """A fixed seed gives the JAX engine's stream alone, beside greedy
    neighbours (which stay equal to ``generate()``), under decode block
    4 and on a speculative engine."""
    out, nb = _sampled_stream(tparams, **case)
    np.testing.assert_array_equal(out, jax_stream)
    for p, o in zip(NEIGHBOURS, nb):
        want = TL.generate(tparams, p[None], TCFG, 6).numpy()[0, p.size:]
        np.testing.assert_array_equal(o, want)
