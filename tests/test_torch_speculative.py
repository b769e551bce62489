"""Speculative decoding in the PyTorch port vs the JAX package.

The draft side (``serving.speculative``: ``NGramDrafter``,
``AcceptancePolicy``, ``resolve_drafter``) is a numpy copy and must
behave as the JAX package's on the same histories and updates. The
verify side (``serving_tick``'s ``spec_k`` mode under
``ServingEngine(speculative=...)``) must leave greedy output bitwise
equal to the port's ``generate()`` and to the JAX package's, whatever
the drafter proposes, in every cache state: cold, warm prefix, chunked
prefill, after ``defragment()``. Tiny config, f32, CPU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.serving import speculative as JS
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import speculative as TS

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


def _jax_ref(jparams, prompt, n):
    out = _gen_jit(n)(jparams, jnp.asarray(prompt)[None])
    return np.asarray(out)[0, len(prompt):]


def _port_ref(tparams, prompt, n):
    return TL.generate(tparams, prompt[None], TCFG, n).numpy()[0,
                                                               len(prompt):]


def _engine(tparams, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 32)
    kw.setdefault("speculative", "ngram")
    kw.setdefault("spec_k", 3)
    return ServingEngine(tparams, TCFG, device="cpu", **kw)


def _repetitive(seed, n=13):
    rng = np.random.RandomState(seed)
    pat = rng.randint(0, TCFG.vocab_size, (4,)).astype(np.int32)
    return np.tile(pat, -(-n // 4))[:n]


class OracleDrafter:
    """Drafts the true greedy continuation: every draft accepted."""

    def __init__(self, full_seq):
        self.full = np.asarray(full_seq, np.int32)

    def propose(self, history, k):
        h = np.asarray(history, np.int32).reshape(-1)
        return self.full[h.size: h.size + k]


class AntiOracleDrafter(OracleDrafter):
    """Every draft wrong (true token + 1 mod V): every draft rejected."""

    def propose(self, history, k):
        return (super().propose(history, k) + 1) % TCFG.vocab_size


# ---------------------------------------------------------------------------
# (iv) the draft side against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_matches_jax(ngram):
    """200 seeded histories (periodic runs, random tokens, short and
    windowed), k from 0 to 5: the same drafts."""
    rng = np.random.RandomState(sum(ngram))
    kw = dict(max_ngram=ngram[0], min_ngram=ngram[1], max_history=64)
    ours, theirs = TS.NGramDrafter(**kw), JS.NGramDrafter(**kw)
    for i in range(200):
        n = int(rng.randint(1, 120))
        if i % 2:
            pat = rng.randint(0, 8, int(rng.randint(1, 6)))
            hist = np.tile(pat, -(-n // pat.size))[:n]
            hist[rng.rand(n) < 0.1] = 9
        else:
            hist = rng.randint(0, 6, n)
        k = int(rng.randint(0, 6))
        got, want = ours.propose(hist, k), theirs.propose(hist, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"history {i}")


def test_acceptance_policy_matches_jax():
    """200 seeded budget / update sequences: the same budgets and the
    same EWMA state after each step."""
    rng = np.random.RandomState(7)

    class State:
        def __init__(self):
            self.spec_rate, self.spec_probe = 1.0, 0

    for k in (1, 3, 4):
        ours, theirs = TS.AcceptancePolicy(k), JS.AcceptancePolicy(k)
        a, b = State(), State()
        for _ in range(200):
            remaining = int(rng.randint(-1, 10))
            assert ours.budget(a, remaining) == theirs.budget(b, remaining)
            drafted = int(rng.randint(0, k + 1))
            accepted = int(rng.randint(0, drafted + 1)) \
                if rng.rand() < 0.5 else 0
            ours.update(a, drafted, accepted)
            theirs.update(b, drafted, accepted)
            assert (a.spec_rate, a.spec_probe) == (b.spec_rate,
                                                   b.spec_probe)
    with pytest.raises(ValueError, match="spec_k"):
        TS.AcceptancePolicy(0)


def test_resolve_drafter_matches_jax():
    fn = lambda h, k: np.asarray(h)[-k:]    # noqa: E731
    for spec in (None, False, "off", "none", True, "ngram"):
        got, want = TS.resolve_drafter(spec), JS.resolve_drafter(spec)
        assert (got is None) == (want is None)
        assert type(got).__name__ == type(want).__name__
    oracle = OracleDrafter(np.arange(20))
    assert TS.resolve_drafter(oracle) is oracle
    wrapped = TS.resolve_drafter(fn)
    np.testing.assert_array_equal(wrapped.propose(np.arange(9), 3),
                                  JS.resolve_drafter(fn).propose(
                                      np.arange(9), 3))
    assert wrapped.propose(np.arange(9), 3).dtype == np.int32
    for bad in ("bogus", 3):
        with pytest.raises(ValueError, match="speculative"):
            TS.resolve_drafter(bad)


# ---------------------------------------------------------------------------
# (v) greedy exactness in every cache state
# ---------------------------------------------------------------------------

def test_spec_matches_generate_cold_warm_partial(jparams, tparams):
    """Cold, fully warm and partially warm prefixes: the speculative
    engine's tokens equal the plain engine's, the port's ``generate()``
    and JAX ``generate()``, with drafts drafted and accepted."""
    base = _repetitive(2, 13)
    partial = np.concatenate([base[:9], _repetitive(11, 5)[:4]])
    outs = {}
    for spec in (None, "ngram"):
        with _engine(tparams, speculative=spec) as eng:
            outs[spec] = [eng.submit(p, 8).result(timeout=300)
                          for p in (base, base, partial)]
            snap = eng.stats()
    for a, b in zip(outs[None], outs["ngram"]):
        np.testing.assert_array_equal(a, b)
    for p, out in zip((base, base, partial), outs["ngram"]):
        np.testing.assert_array_equal(out, _port_ref(tparams, p, 8))
        np.testing.assert_array_equal(out, _jax_ref(jparams, p, 8))
    c = snap["counters"]
    assert c["draft_tokens"] > 0 and c["draft_accepted"] > 0
    assert c["spec_ticks"] > 0 and c["prefix_hits"] >= 2


@pytest.mark.parametrize("chunk", [4, 5])
def test_spec_matches_generate_chunked_prefill(jparams, tparams, chunk):
    """Prefill spans and verify spans share the packed tick, for aligned
    and unaligned chunk sizes."""
    prompts = [_repetitive(s, n) for s, n in ((2, 15), (5, 9), (7, 13))]
    with _engine(tparams, prefill_chunk=chunk) as eng:
        outs = [h.result(timeout=300)
                for h in [eng.submit(p, 6) for p in prompts]]
        c = eng.stats()["counters"]
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, _jax_ref(jparams, p, 6))
    assert c["spec_ticks"] > 0


def test_spec_matches_generate_after_defragment(jparams, tparams):
    """A mid-stream defrag moves a speculating slot's pages (a short
    request admitted beside it retired, leaving a hole under them);
    verify spans read the remapped tables, and the tokens stay exact."""
    p1, p2 = _repetitive(2, 11), _repetitive(5, 7)
    with _engine(tparams) as eng:
        h0 = eng.submit(p2, 2)
        h1 = eng.submit(p1, 24)
        h0.result(timeout=300)
        next(iter(h1))
        moved = eng.defragment()
        h2 = eng.submit(p2, 6)
        out1, out2 = h1.result(timeout=300), h2.result(timeout=300)
        c = eng.stats()["counters"]
    assert moved > 0
    np.testing.assert_array_equal(out1, _jax_ref(jparams, p1, 24))
    np.testing.assert_array_equal(out2, _jax_ref(jparams, p2, 6))
    assert c["spec_ticks"] > 0


# ---------------------------------------------------------------------------
# (vii) the full-accept and the all-reject paths
# ---------------------------------------------------------------------------

def test_oracle_drafter_full_accept_path(tparams):
    """Every draft accepted: 24 post-prefill tokens in a handful of
    4-token verify launches, the output still exact."""
    prompt, mnt = _repetitive(2, 13), 25
    full = np.concatenate([prompt, _port_ref(tparams, prompt, mnt)])
    with _engine(tparams, speculative=OracleDrafter(full)) as eng:
        out = eng.submit(prompt, mnt).result(timeout=300)
        c = eng.stats()["counters"]
    np.testing.assert_array_equal(out, full[len(prompt):])
    assert c["draft_accepted"] == c["draft_tokens"] > 0
    assert c["decode_steps"] <= 8


def test_anti_oracle_rejected_and_degrades(tparams):
    """Every draft rejected: the output exact, and the acceptance policy
    degrades the slot to plain decode (probes only)."""
    prompt, mnt = _repetitive(2, 13), 30
    full = np.concatenate([prompt, _port_ref(tparams, prompt, mnt)])
    with _engine(tparams, speculative=AntiOracleDrafter(full)) as eng:
        out = eng.submit(prompt, mnt).result(timeout=300)
        c = eng.stats()["counters"]
    np.testing.assert_array_equal(out, full[len(prompt):])
    assert c["draft_accepted"] == 0
    assert c["draft_rejected"] == c["draft_tokens"] > 0
    assert c["spec_ticks"] < mnt // 2


def test_spec_engine_rejects_bad_arguments(tparams):
    with pytest.raises(ValueError, match="spec_k"):
        _engine(tparams, spec_k=0)
