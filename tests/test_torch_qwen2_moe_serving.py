"""Qwen2-MoE cached decode and serving in the PyTorch port vs the JAX
package.

``_decode_block``, ``forward_with_cache`` and ``generate`` (greedy,
sampled, EOS latch), every serving function (``serving_prefill``,
``serving_prefill_chunk``, ``serving_decode_step``,
``serving_decode_block``, ``serving_tick`` with a decode tail and in its
speculative verify mode, ``serving_tick_block`` greedy and sampled),
``ServingEngine`` on Qwen2-MoE params (plain, warm prefix, chunked
prefill, speculative, a seeded sampled stream), its ``model=``
resolution, weight-only int8 (``quantize_for_decode``'s MoE branch,
int8 ``generate`` and the int8 engine) and the random second-expert
gating policy.

Weights come from the JAX init through ``params_from_jax``, other inputs
from numpy with a seed; JAX runs with ``use_flash_attention=False`` (its
dense attention on the CPU), the port its kernels' plain versions (CPU
tensors). Contract (tiny config, f32): logits and pools within rtol /
atol 1e-5; greedy tokens equal exactly; quantization, dequantization and
the random gating's dispatch bitwise; sampled tokens equal wherever the top two
perturbed logits differ by more than 1e-5, with no row under that margin.

Inside the port the relations of a request's greedy tokens hold exactly
(``generate`` = the argmax of the stepwise full ``forward``; the engine =
``generate`` alone, beside neighbours, warm, chunked or speculative),
but a row's logits depend on what shares its tick at the level of f32
rounding, so the cohort relations (a decode row alone or in a mixed
tick; a prompt chunked or whole) hold within 1e-5 and at tokens, not
bitwise as Llama's do: the shared expert's gate ``x @ gate`` is a
``[D, 1]`` matrix-vector product, whose BLAS path sums a row in an order
that depends on the row count, and the drop-free einsum runs the experts
on ``[E, C, D]`` with C the cohort size, so the product's shape, and the
kernel BLAS picks for it, change with the cohort.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.moe import functional as JF
from paddle_tpu.models import qwen2_moe as JQ
from paddle_tpu.ops.pallas.flash_attention import flash_attention as j_fa
from paddle_tpu.quantization import decode as JD
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import prng
from paddle_tpu_torch.incubate.moe import functional as TF
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ
from paddle_tpu_torch.ops.fused.int8_matmul import Int8Weight
from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
from paddle_tpu_torch.quantization import decode as TD
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.engine import _resolve_model

JCFG = JQ.Qwen2MoeConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                              remat=False)
TCFG = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32)
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-5
SAMP = dict(temperature=0.8, top_p=0.9, top_k=40)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return JQ.init_params(JCFG, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TQ.params_from_jax(_np_tree(jparams), device="cpu")


@pytest.fixture(scope="module")
def jqparams(jparams):
    return JD.quantize_for_decode(jparams, JCFG)


@pytest.fixture(scope="module")
def tqparams(jqparams):
    return TQ.params_from_jax(_np_tree(jqparams), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_generate(n, **kw):
    return jax.jit(lambda p, t: JQ.generate(p, t, JCFG, max_new_tokens=n,
                                            **kw))


def _jax_ref(jparams, prompt, n):
    """JAX generate()'s continuation of one prompt."""
    return np.asarray(_jax_generate(n)(jparams,
                                       jnp.asarray(prompt)[None]))[0,
                                                                   len(prompt):]


def _margin(perturbed):
    top = perturbed.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


# ---------------------------------------------------------------------------
# the block, the dense cache and generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["dense", "int8"])
def test_decode_block_matches_jax(jparams, tparams, jqparams, tqparams,
                                  weights):
    """One layer of ``_decode_block`` over causal attention, dense and
    weight-only int8 (the experts dequantized, the rest on the int8
    product)."""
    jp, tp = ((jparams, tparams) if weights == "dense"
              else (jqparams, tqparams))
    rng = np.random.RandomState(5)
    h = rng.randn(2, 7, JCFG.hidden_size).astype(np.float32)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    jlp = jax.tree_util.tree_map(lambda x: x[1], jp["layers"])
    want = JQ._decode_block(
        jlp, jnp.asarray(h), jnp.asarray(pos), JCFG,
        lambda q, k, v: j_fa(q, k, v, causal=True, impl="dense"))
    got = TQ._decode_block(
        TL._layer(tp, 1), _t(h), _t(pos), TCFG,
        lambda q, k, v: flash_attention(q, k, v, causal=True))
    _close(got, want)


def test_forward_with_cache_matches_jax(jparams, tparams):
    """A 9-token prefill then 6 single-token steps: every step's logits
    and the caches at the end."""
    rng = np.random.RandomState(6)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    steps = rng.randint(0, JCFG.vocab_size, (6, 2)).astype(np.int32)
    jc = JQ.init_kv_cache(JCFG, 2, 15)
    tc = TQ.init_kv_cache(TCFG, 2, 15, "cpu")
    jl, jc = JQ.forward_with_cache(jparams, jnp.asarray(prompt), jc, 0, JCFG)
    tl, tc2 = TQ.forward_with_cache(tparams, _t(prompt), tc, 0, TCFG)
    assert tc2 is tc and tl.dtype == torch.float32
    _close(tl, jl)
    for i, tok in enumerate(steps):
        jl, jc = JQ.forward_with_cache(jparams, jnp.asarray(tok)[:, None],
                                       jc, 9 + i, JCFG)
        tl, tc = TQ.forward_with_cache(tparams, _t(tok)[:, None], tc, 9 + i,
                                       TCFG)
        _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_generate_greedy_and_eos_match_jax(jparams, tparams):
    """B 2, T0 9, N 6: greedy tokens equal JAX's, with and without an EOS
    that latches (every later position repeats it)."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(_jax_generate(6)(jparams, jnp.asarray(prompt)))
    got = TQ.generate(tparams, prompt, TCFG, 6)
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    eos = int(want[0, 11])
    want = np.asarray(_jax_generate(6, eos_token_id=eos)(
        jparams, jnp.asarray(prompt)))
    got = TQ.generate(tparams, prompt, TCFG, 6, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0, 9:] == eos))
    assert (got[0, 9 + first:] == eos).all()


def test_sampled_generate_matches_jax(jparams, tparams):
    """The split chain from one key: the port's tokens equal JAX's, and
    no step of the port's run has a row whose two largest perturbed
    logits sit within the margin."""
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t, k: JQ.generate(
        p, t, JCFG, max_new_tokens=6, key=k, **SAMP))(
        jparams, jnp.asarray(prompt), jax.random.PRNGKey(11)))
    got = TQ.generate(tparams, prompt, TCFG, 6, key=prng.key(11), **SAMP)
    np.testing.assert_array_equal(got.numpy(), want)
    key, close = prng.key(11), 0
    cache = TQ.init_kv_cache(TCFG, 2, 15, "cpu")
    logits, cache = TQ.forward_with_cache(tparams, _t(prompt), cache, 0,
                                          TCFG)
    for i in range(6):
        key, sub = prng.split(key)
        pert = (TL._sample_mask(logits, SAMP["temperature"], SAMP["top_p"],
                                SAMP["top_k"])
                + prng.gumbel(sub, logits.shape))
        close += int((_margin(pert) <= MARGIN).sum())
        if i < 5:
            logits, cache = TQ.forward_with_cache(
                tparams, got[:, 9 + i:10 + i], cache, 9 + i, TCFG)
    assert close == 0


def test_generate_is_the_stepwise_forward_argmax(tparams):
    """Inside the port (JAX's tests/test_moe.py relation): greedy cached
    decode equals re-running the full training ``forward`` (capacity
    factor 2 drops nothing at tiny's E = 4, top-2) on the growing
    sequence."""
    prompt = np.random.RandomState(1).randint(
        0, TCFG.vocab_size, (2, 9)).astype(np.int32)
    out = TQ.generate(tparams, prompt, TCFG, 6)
    seq = _t(prompt)
    with torch.no_grad():
        for _ in range(6):
            logits, _ = TQ.forward(tparams, seq, TCFG)
            nxt = logits[:, -1].float().argmax(-1).int()
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


# ---------------------------------------------------------------------------
# the serving functions
# ---------------------------------------------------------------------------

S, PS, PPS = 3, 4, 6


def _pools(seed):
    rng = np.random.RandomState(seed)
    L, Hkv, Dh = JCFG.num_hidden_layers, JCFG.num_key_value_heads, \
        JCFG.head_dim
    P = 1 + S * PPS
    kp = rng.randn(L, Hkv, P, PS, Dh).astype(np.float32)
    vp = rng.randn(L, Hkv, P, PS, Dh).astype(np.float32)
    tables = (1 + rng.permutation(S * PPS)).reshape(S, PPS).astype(np.int32)
    return rng, kp, vp, tables


def _close_pools(tp, jp):
    """Pools within the tolerance, the trash page (padding's writes)
    left out."""
    for a, b in zip(tp, jp):
        _close(a.numpy()[:, :, 1:], np.asarray(b)[:, :, 1:])


def test_serving_prefill_and_chunk_match_jax(jparams, tparams):
    """A whole 7-token prompt, then a 6-token chunk behind 2 cached
    pages: logits and the pools' written pages."""
    _, kp, vp, tables = _pools(3)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, JCFG.vocab_size, (1, 8)).astype(np.int32)
    jl, jkp, jvp = JQ.serving_prefill(
        jparams, jnp.asarray(toks), jnp.int32(7), jnp.asarray(tables[0]),
        jnp.asarray(kp), jnp.asarray(vp), JCFG)
    tkp, tvp = _t(kp), _t(vp)
    tl, tkp2, _ = TQ.serving_prefill(tparams, toks, 7, tables[0], tkp, tvp,
                                     TCFG)
    assert tkp2 is tkp and tl.shape == (JCFG.vocab_size,)
    _close(tl, jl)
    _close_pools((tkp, tvp), (jkp, jvp))
    chunk = rng.randint(0, JCFG.vocab_size, (1, 8)).astype(np.int32)
    jl, jkp, jvp = JQ.serving_prefill_chunk(
        jparams, jnp.asarray(chunk), jnp.int32(6), jnp.asarray(tables[0]),
        jkp, jvp, JCFG, prefix_pages=2)
    tl, _, _ = TQ.serving_prefill_chunk(tparams, chunk, 6, tables[0], tkp,
                                        tvp, TCFG, prefix_pages=2)
    _close(tl, jl)
    _close_pools((tkp, tvp), (jkp, jvp))


def test_serving_decode_step_and_block_match_jax(jparams, tparams):
    """All slots' decode step (one dead, all-trash slot): logits of the
    live slots and pools; then three greedy steps of the block: tokens
    exact, pools."""
    _, kp, vp, tables = _pools(2)
    tables[2] = 0
    tok = np.asarray([5, 17, 0], np.int32)
    lengths = np.asarray([7, 13, 0], np.int32)
    args = (jnp.asarray(tok), jnp.asarray(lengths), jnp.asarray(tables),
            jnp.asarray(kp), jnp.asarray(vp), JCFG)
    jl, jkp, jvp = JQ.serving_decode_step(jparams, *args, attn_impl="dense")
    tkp, tvp = _t(kp), _t(vp)
    tl, _, _ = TQ.serving_decode_step(tparams, _t(tok), _t(lengths),
                                      _t(tables), tkp, tvp, TCFG)
    _close(tl[:2], np.asarray(jl)[:2])
    _close_pools((tkp, tvp), (jkp, jvp))
    jt, jkp, jvp = JQ.serving_decode_block(jparams, *args, num_steps=3,
                                           attn_impl="dense")
    tkp, tvp = _t(kp), _t(vp)
    tt, _, _ = TQ.serving_decode_block(tparams, _t(tok), _t(lengths),
                                       _t(tables), tkp, tvp, TCFG,
                                       num_steps=3)
    assert tt.dtype == torch.int32 and tt.shape == (3, 3)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    _close_pools((tkp, tvp), (jkp, jvp))


def _samp(S_=S):
    return dict(temp=np.asarray([0.9, 0.0, 0.7][:S_], np.float32),
                top_p=np.asarray([0.95, 1.0, 0.5][:S_], np.float32),
                top_k=np.asarray([0, 0, 30][:S_], np.int32),
                key=np.stack([np.asarray(jax.random.PRNGKey(s))
                              for s in (42, 0, -3)[:S_]]),
                produced=np.asarray([3, 0, 11][:S_], np.int32))


def _run_ticks(jparams, tparams, tok, meta, kp, vp, **kw):
    """The same tick through JAX's ``serving_tick`` and the port's."""
    jmeta = {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor)
                            else v) for k, v in meta.items()}
    jout = JQ.serving_tick(jparams, jnp.asarray(tok.numpy()), jmeta,
                           jnp.asarray(kp), jnp.asarray(vp), JCFG, **kw)
    tmeta = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
        v.astype(np.int64) if k == "key" else v)) for k, v in meta.items()}
    kw.pop("tq")
    tkp, tvp = _t(kp), _t(vp)
    tout = TQ.serving_tick(tparams, tok, tmeta, tkp, tvp, TCFG, **kw)
    return jout, tout, (tkp, tvp)


@pytest.mark.parametrize("sampled", [False, True])
def test_serving_tick_with_tail_matches_jax(jparams, tparams, sampled):
    """A mixed tick (a decode row, a mid-prompt span, a completing span)
    with a decode tail of 2: every pick, the logits and the pools."""
    rng, kp, vp, tables = _pools(1)
    tok, meta = TL.pack_tick(
        [(0, 5, 7)], [(1, rng.randint(0, 256, 5).astype(np.int32), 4),
                      (2, rng.randint(0, 256, 6).astype(np.int32), 0)],
        tables, PS, "cpu")
    meta["tail_live"] = torch.tensor([True, False, True])
    if sampled:
        meta.update(_samp())
    (jt, jl, jkp, jvp), (tt, tl, _, _), tpools = _run_ticks(
        jparams, tparams, tok, meta, kp, vp, tq=6, decode_tail=2)
    assert tt.shape == (3, 3) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy()[[0, 2]], np.asarray(jt)[[0, 2]])
    _close(tl, jl)
    _close_pools(tpools, (jkp, jvp))


def test_verify_tick_matches_jax(jparams, tparams):
    """The speculative verify pass (spec_k 3): slot 0 drafts 3 tokens,
    slot 1 decodes plainly, slot 2 prefills; picks at every span
    position, acceptance and row-0 logits (JAX returns ``[:, 0]``)."""
    rng, kp, vp, tables = _pools(2)
    tok, meta = TL.pack_tick(
        [(1, 9, 3)], [(2, rng.randint(0, 256, 5).astype(np.int32), 0)],
        tables, PS, "cpu", spec_k=3,
        drafts=[(0, 5, 7, np.asarray([5, 9, 2], np.int32))])
    (jt, ja, jl, jkp, jvp), (tt, ta, tl, _, _), tpools = _run_ticks(
        jparams, tparams, tok, meta, kp, vp, tq=5, spec_k=3)
    assert tl.shape == (3, 4, TCFG.vocab_size)
    _close(tl[:, 0], jl)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close_pools(tpools, (jkp, jvp))


@pytest.mark.parametrize("sampled", [False, True])
def test_serving_tick_block_matches_jax(jparams, tparams, sampled):
    """Three fused steps for two live slots and a dead one, greedy and
    with in-tick sampling (step j drawing index produced + j)."""
    _, kp, vp, tables = _pools(7)
    tables[2] = 0
    tok = np.asarray([5, 17, 0], np.int32)
    lengths = np.asarray([7, 9, 0], np.int32)
    samp = _samp() if sampled else None
    jt, jkp, jvp = JQ.serving_tick_block(
        jparams, jnp.asarray(tok), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(kp), jnp.asarray(vp), JCFG,
        num_steps=3, sampling=(None if samp is None else
                               {k: jnp.asarray(v) for k, v in samp.items()}))
    tkp, tvp = _t(kp), _t(vp)
    tsamp = None if samp is None else {
        k: torch.from_numpy(v.astype(np.int64) if k == "key" else v)
        for k, v in samp.items()}
    tt, _, _ = TQ.serving_tick_block(
        tparams, _t(tok), _t(lengths), _t(tables), tkp, tvp, TCFG,
        num_steps=3, sampling=tsamp)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    _close_pools((tkp, tvp), (jkp, jvp))


def test_cohort_relations_hold_at_tokens(tparams):
    """Inside the port: a decode row alone or beside a prompt span, and
    a prompt prefilled in two chunks or whole, give the same tokens and
    logits and pools within 1e-5 (not bitwise: see the module's
    docstring)."""
    rng, kp, vp, tables = _pools(9)
    span = rng.randint(0, 256, 7).astype(np.int32)

    def tick(decode, spans, k, v):
        tok, meta = TL.pack_tick(decode, spans, tables, PS, "cpu")
        return TQ.serving_tick(tparams, tok, meta, k, v, TCFG)

    alone = tick([(0, 5, 7)], [], _t(kp), _t(vp))
    mixed = tick([(0, 5, 7)], [(1, span, 4)], _t(kp), _t(vp))
    assert int(alone[0][0]) == int(mixed[0][0])
    _close(alone[1][0], mixed[1][0])
    ka, va = _t(kp), _t(vp)
    tick([], [(1, span[:3], 4)], ka, va)
    chunked = tick([], [(1, span[3:], 7)], ka, va)
    kb, vb = _t(kp), _t(vp)
    whole = tick([], [(1, span, 4)], kb, vb)
    assert int(chunked[0][1]) == int(whole[0][1])
    _close(chunked[1][1], whole[1][1])
    _close(ka, kb)
    _close(va, vb)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_prompt_len", 16)
    kw.setdefault("max_new_tokens_cap", 16)
    return ServingEngine(params, TCFG, device="cpu", **kw)


def _repetitive(seed, n=11):
    rng = np.random.RandomState(seed)
    pat = rng.randint(0, TCFG.vocab_size, (4,)).astype(np.int32)
    return np.tile(pat, -(-n // 4))[:n]


@pytest.mark.parametrize("engine_kw", [
    dict(max_prompt_len=8, max_new_tokens_cap=8),
    dict(prefill_chunk=3, decode_block_size=2),
    dict(speculative="ngram", spec_k=3)],
    ids=["plain", "chunked_block2", "speculative"])
def test_engine_matches_jax_generate(jparams, tparams, engine_kw):
    """JAX's tests/test_serving.py Qwen2-MoE specs (more requests than
    slots) and a periodic prompt: every continuation equals JAX
    generate()."""
    rng = np.random.RandomState(3)
    specs = [(rng.randint(0, TCFG.vocab_size, (n,)).astype(np.int32), m)
             for n, m in ((3, 5), (7, 3), (5, 6))]
    specs.append((_repetitive(2, 8), 6))
    with _engine(tparams, **engine_kw) as eng:
        outs = [h.result(timeout=300)
                for h in [eng.submit(p, m) for p, m in specs]]
        c = eng.stats()["counters"]
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _jax_ref(jparams, p, m))
    if "speculative" in engine_kw:
        assert c["spec_ticks"] > 0
    if "prefill_chunk" in engine_kw:
        assert c["prefill_chunks"] > len(specs)


def test_engine_warm_prefix_matches_jax_generate(jparams, tparams):
    """JAX's tests/test_prefix_cache.py Qwen2-MoE relation: cold, then a
    fully cached prefix attached, then a partial one; a defrag between
    them moves nothing that matters."""
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, TCFG.vocab_size, (7,)).astype(np.int32)
    part = np.concatenate([prompt[:4], rng.randint(0, TCFG.vocab_size, 3)
                           .astype(np.int32)])
    with _engine(tparams, page_size=2, max_prompt_len=8,
                 max_new_tokens_cap=8) as eng:
        outs = [eng.submit(prompt, 5).result(timeout=300),
                eng.submit(prompt, 5).result(timeout=300)]
        eng.defragment()
        outs.append(eng.submit(part, 5).result(timeout=300))
        c = eng.stats()["counters"]
    for p, out in zip((prompt, prompt, part), outs):
        np.testing.assert_array_equal(out, _jax_ref(jparams, p, 5))
    assert c["prefix_hits"] == 2


def test_sampled_stream_matches_jax_engine(jparams, tparams):
    """One seeded sampled request through the JAX engine and the port's,
    beside a greedy neighbour in the port's."""
    prompt = np.random.RandomState(8).randint(
        0, TCFG.vocab_size, (9,)).astype(np.int32)
    stream = dict(temperature=0.9, top_p=0.95, top_k=50, seed=42)
    kw = dict(max_batch=2, page_size=4, max_prompt_len=16,
              max_new_tokens_cap=16)
    with JaxEngine(jparams, JCFG, **kw) as eng:
        want = eng.submit(prompt, 8, **stream).result(timeout=300)
    with _engine(tparams, **kw) as eng:
        nb = eng.submit(prompt[::-1].copy(), 6)
        got = eng.submit(prompt, 8, **stream).result(timeout=300)
        nb = nb.result(timeout=300)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        nb, TQ.generate(tparams, prompt[None, ::-1].copy(), TCFG,
                        6).numpy()[0, 9:])


def test_model_resolution():
    """``model=``: names, a module as given, the config's type name when
    None; an unknown name raises as in the JAX package."""
    lcfg = TL.LlamaConfig.tiny()
    assert _resolve_model(None, TCFG) is TQ
    assert _resolve_model(None, lcfg) is TL
    assert _resolve_model("qwen2_moe", lcfg) is TQ
    assert _resolve_model("llama", TCFG) is TL
    assert _resolve_model(TQ, lcfg) is TQ
    with pytest.raises(ValueError, match="cannot infer serving model"):
        _resolve_model("gpt2", TCFG)
    with pytest.raises(ValueError, match="cannot infer serving model"):
        ServingEngine({}, TCFG, model="gpt2", device="cpu")


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

def test_quantize_for_decode_moe_matches_jax(jparams, tparams, tqparams):
    """The MoE branch quantizes to the JAX bits: attention, the routed
    experts per (layer, expert, channel), the shared expert and lm_head;
    the router and the shared gate stay dense; dequantization is JAX's
    bitwise; ``quantize_lm_head=False`` keeps lm_head; a layer slices
    both leaves."""
    got = TD.quantize_for_decode(tparams, TCFG)
    lay, ref = got["layers"], tqparams["layers"]
    pairs = [(lay[k], ref[k]) for k in ("wq", "wk", "wv", "wo")]
    for grp in ("experts", "shared"):
        pairs += [(lay[grp][k], ref[grp][k])
                  for k in ("w_gate", "w_up", "w_down")]
    pairs.append((got["lm_head"], tqparams["lm_head"]))
    for w, r in pairs:
        assert isinstance(w, Int8Weight)
        assert torch.equal(w.q, r.q) and torch.equal(w.scale, r.scale)
    L, E = TCFG.num_hidden_layers, TCFG.num_experts
    assert lay["experts"]["w_gate"].scale.shape == (
        L, E, TCFG.moe_intermediate_size)
    assert lay["router"] is tparams["layers"]["router"]
    assert lay["shared"]["gate"] is tparams["layers"]["shared"]["gate"]
    jdq = JD.dequantize_for_decode(JD.quantize_for_decode(jparams, JCFG),
                                   jnp.float32)
    tdq = TD.dequantize_for_decode(got, torch.float32)
    np.testing.assert_array_equal(tdq["layers"]["experts"]["w_down"].numpy(),
                                  np.asarray(jdq["layers"]["experts"]
                                             ["w_down"]))
    tb = TD.quantize_for_decode(tparams, TCFG, quantize_lm_head=False)
    assert tb["lm_head"] is tparams["lm_head"]
    assert TD.decode_weight_bytes(tb) == JD.decode_weight_bytes(
        JD.quantize_for_decode(jparams, JCFG, quantize_lm_head=False))
    assert TD.decode_weight_bytes(got) == JD.decode_weight_bytes(
        JD.quantize_for_decode(jparams, JCFG))
    lp = TL._layer(got, 1)["experts"]["w_up"]
    assert lp.q.shape == (E, TCFG.hidden_size, TCFG.moe_intermediate_size)
    assert lp.scale.shape == (E, TCFG.moe_intermediate_size)
    with pytest.raises(ValueError, match="already"):
        TD.quantize_for_decode(got, TCFG)


def test_int8_generate_and_engine(jqparams, tparams, tqparams):
    """Int8 ``generate`` equals JAX's on the JAX-quantized params; the
    int8 engine (quantizing the dense params at construction) equals the
    port's ``generate`` on the same quantized params."""
    rng = np.random.RandomState(10)
    prompt = rng.randint(0, TCFG.vocab_size, (2, 5)).astype(np.int32)
    want = np.asarray(_jax_generate(8)(jqparams, jnp.asarray(prompt)))
    got = TQ.generate(tqparams, prompt, TCFG, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    prompts = [np.asarray([3, 1, 4], np.int32), prompt[0], prompt[1]]
    with _engine(tparams, quantization="int8") as eng:
        assert TD.is_quantized_params(eng._params)
        outs = [h.result(timeout=300)
                for h in [eng.submit(p, 6) for p in prompts]]
    for p, out in zip(prompts, outs):
        ref = TQ.generate(tqparams, p[None], TCFG, 6).numpy()[0, p.size:]
        np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# random second-expert gating
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, -3])
def test_random_second_expert_gating_matches_jax(seed):
    """``second_policy="random"`` for one key, top-2 and top-3: the
    dispatch (which experts were kept by the uniform draws, and at which
    slot) bitwise JAX's; combine and the aux loss within rtol 1e-6 (they
    carry the router softmax, whose exp rounds differently in XLA and
    PyTorch in the last ulp); some later experts were dropped."""
    logits = np.random.RandomState(20 + seed % 5).randn(64, 6).astype(
        np.float32)
    for top_k in (2, 3):
        want = JF.top_k_gating(jnp.asarray(logits), top_k, 40,
                               key=jax.random.PRNGKey(seed),
                               second_policy="random")
        got = TF.top_k_gating(_t(logits), top_k, 40, key=prng.key(seed),
                              second_policy="random")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=0)
        dispatched = got[0].sum((1, 2))
        assert int((dispatched < top_k).sum()) > 0


def test_entry_points_raise_without_cuda():
    """The new entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    calls = [lambda: TQ.init_kv_cache(TCFG, 1, 8),
             lambda: TQ.init_serving_pages(TCFG, 4, 4),
             lambda: ServingEngine({"embed": torch.zeros(1)}, TCFG)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
