"""Paged decode of the PyTorch port vs the JAX package.

``paddle_tpu_torch.inference.paged_kv`` (page writes, paged attention
with and without the dense tail) and the paged Llama paths
(``generate_paged``, the serving steps, ``GenerationPredictor``). Weights
come from the JAX init through ``params_from_jax``; inputs are seeded
numpy arrays handed to both. JAX runs its paged attention as its own
tests do on the CPU (``impl="dense"``, its plain formulation); the port
runs its kernels' plain versions on CPU tensors. Contract (tiny config,
f32): page writes bitwise; attention (o, m, l) within rtol 1e-5;
logits within rtol 1e-5; greedy tokens equal exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference import GenerationPredictor as JPredictor
from paddle_tpu.inference import paged_kv as JP
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import prng
from paddle_tpu_torch.inference import GenerationPredictor as TPredictor
from paddle_tpu_torch.inference import paged_kv as TP
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.kernels.paged_attention import (
    KEY_CHUNK, paged_attention_stats, split_plan)

JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


def _attn_case(seed=0, B=3, H=4, Hkv=2, Dh=8, ps=4, pps=5, nan=False):
    """Mixed lengths over shuffled page tables; trash and stale slots
    hold random values (NaN with ``nan``)."""
    rng = np.random.RandomState(seed)
    P = 1 + B * pps
    tables = (1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32)
    lens = np.asarray([1, 9, pps * ps][:B], np.int32)
    for b in range(B):
        tables[b, -(-lens[b] // ps):] = 0
    kp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    if nan:
        kp[:, 0] = vp[:, 0] = np.nan
        b = 1
        kp[:, tables[b, lens[b] // ps], lens[b] % ps:] = np.nan
        vp[:, tables[b, lens[b] // ps], lens[b] % ps:] = np.nan
    q = rng.randn(B, H, Dh).astype(np.float32)
    return q, kp, vp, lens, tables


def test_page_writes_match_jax_bitwise():
    """write_prompt_pages (whole and at an offset), write_token_pages,
    prompt_pages_from_dense and apply_defrag give the JAX bits (the
    trash page, where colliding padding writes land, excluded)."""
    rng = np.random.RandomState(1)
    Hkv, P, ps, Dh, B, T0 = 2, 9, 4, 8, 2, 6
    kp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(Hkv, P, ps, Dh).astype(np.float32)
    tables = np.asarray([[3, 1, 7, 0], [2, 8, 5, 6]], np.int32)
    k = rng.randn(B, T0, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, T0, Hkv, Dh).astype(np.float32)
    lens = np.asarray([5, 3], np.int32)
    for offset in (0, 8):
        jk, jv = JP.write_prompt_pages(jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lens),
                                       jnp.asarray(tables), offset=offset)
        tk, tv = _t(kp), _t(vp)
        out = TP.write_prompt_pages(tk, tv, _t(k), _t(v), _t(lens),
                                    _t(tables), offset=offset)
        assert out[0] is tk and out[1] is tv          # in place
        np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
        np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    kt = rng.randn(B, Hkv, Dh).astype(np.float32)
    tlens = np.asarray([7, 16], np.int32)     # 16: past the table -> trash
    jk, jv = JP.write_token_pages(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(kt), jnp.asarray(kt),
                                  jnp.asarray(tlens), jnp.asarray(tables))
    tk, tv = _t(kp), _t(vp)
    TP.write_token_pages(tk, tv, _t(kt), _t(kt), _t(tlens), _t(tables))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    jk, jv, jt = JP.prompt_pages_from_dense(jnp.asarray(k), jnp.asarray(v),
                                            ps)
    tk, tv, tt = TP.prompt_pages_from_dense(_t(k), _t(v), ps)
    for a, b in ((tk, jk), (tv, jv), (tt, jt)):
        assert a.dtype == (torch.int32 if b.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    pool = JP.PagePool(total_pages=P, page_size=ps)
    held = pool.alloc(7)
    pool.free([held[1], held[4]])
    plan = pool.defrag_plan()
    assert plan
    stacked = rng.randn(3, Hkv, P, ps, Dh).astype(np.float32)
    want = JP.apply_defrag(plan, jnp.asarray(stacked), jnp.asarray(stacked),
                           jnp.asarray(tables))
    got = TP.apply_defrag(plan, _t(stacked), _t(stacked), _t(tables))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_paged_attention_matches_jax(G):
    """o of paged_attention, (o, m, l) of the stats entry, and
    paged_attention_with_tail: mixed lengths, shuffled tables, page
    size 4; rtol 1e-5."""
    q, kp, vp, lens, tables = _attn_case(seed=G, H=2 * G)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, lens, tables)]
    targs = [_t(a) for a in (q, kp, vp, lens, tables)]
    want = JP.paged_attention(*jargs, impl="dense")
    got = TP.paged_attention(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)
    scale = 1.0 / np.sqrt(q.shape[-1])
    qs = (jargs[0] * scale).astype(jnp.float32)
    want = JP._ref_paged_attention_stats(qs, *jargs[1:])
    got = paged_attention_stats(*targs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL)
    rng = np.random.RandomState(G)
    B, Hkv, Dh = q.shape[0], kp.shape[0], q.shape[-1]
    kt = rng.randn(B, 5, Hkv, Dh).astype(np.float32)
    vt = rng.randn(B, 5, Hkv, Dh).astype(np.float32)
    want = JP.paged_attention_with_tail(*jargs, jnp.asarray(kt),
                                        jnp.asarray(vt), 3, impl="dense")
    got = TP.paged_attention_with_tail(*targs, _t(kt), _t(vt), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_paged_attention_never_reads_past_the_length():
    """NaN in the trash page and in a last page's stale slots stays out
    of o, m and l; a sequence's outputs do not depend on the batch."""
    q, kp, vp, lens, tables = _attn_case(seed=7, nan=True)
    o, m, l = paged_attention_stats(*(_t(a) for a in (q, kp, vp, lens,
                                                      tables)))
    assert torch.isfinite(o).all() and torch.isfinite(m).all() \
        and torch.isfinite(l).all()
    alone = paged_attention_stats(_t(q[1:2]), _t(kp), _t(vp), _t(lens[1:2]),
                                  _t(tables[1:2]))
    for a, b in zip(alone, (o, m, l)):
        np.testing.assert_allclose(a.numpy(), b[1:2].numpy(), rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.parametrize("keys,chunks", [
    (KEY_CHUNK - 1, 1), (KEY_CHUNK, 1), (KEY_CHUNK + 1, 2),
    (2 * KEY_CHUNK, 2), (1, 1)])
def test_split_plan_at_the_chunk_edges(keys, chunks):
    """The paged kernel's fixed split: a table of ``keys`` keys (pages x
    page size) gives ``ceil(keys / KEY_CHUNK)`` chunks, and the workspace
    holds each row's (O, m, l) for every chunk, none for one chunk. The
    plan reads the table's width and the rows alone: B = 8 rows of H = 4
    heads at Dh 128."""
    assert KEY_CHUNK == 512
    rows = 8 * 4
    got, floats = split_plan(keys, rows, 128)
    assert got == chunks
    assert floats == (0 if chunks == 1 else chunks * rows * 130)


def _ragged_prompt(lens, T0, seed=10):
    rng = np.random.RandomState(seed)
    rows = [rng.randint(0, JCFG.vocab_size, size=n).astype(np.int32)
            for n in lens]
    prompt = np.zeros((len(lens), T0), np.int32)
    for i, r in enumerate(rows):
        prompt[i, :len(r)] = r
    return rows, prompt


@pytest.mark.parametrize("lens", [[12, 12], [5, 9, 12]],
                         ids=["equal", "ragged"])
def test_generate_paged_matches_jax_exactly(jparams, tparams, lens):
    rows, prompt = _ragged_prompt(lens, 12)
    want = JL.generate_paged(jparams, jnp.asarray(prompt),
                             jnp.asarray(lens, jnp.int32), JCFG, 6,
                             page_size=4)
    got = TL.generate_paged(tparams, prompt, np.asarray(lens), TCFG, 6,
                            page_size=4)
    assert got.dtype == torch.int32 and got.shape == (len(lens), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_paged_pins_inside_the_port(tparams):
    """Paged equals dense generate (equal lengths), greedy and sampled
    from one key; each ragged row equals its own unpadded dense decode;
    EOS latches."""
    lens = [5, 9, 12]
    rows, prompt = _ragged_prompt(lens, 12, seed=11)
    paged = TL.generate_paged(tparams, prompt, np.asarray(lens), TCFG, 6,
                              page_size=4).numpy()
    for i, r in enumerate(rows):
        dense = TL.generate(tparams, r[None], TCFG, 6).numpy()[0, lens[i]:]
        np.testing.assert_array_equal(paged[i], dense, err_msg=f"row {i}")
    eos = int(paged[0, 2])
    out = TL.generate_paged(tparams, prompt, np.asarray(lens), TCFG, 6,
                            page_size=4, eos_token_id=eos).numpy()
    for row, full in zip(out, paged):
        hits = np.where(full == eos)[0]
        if hits.size:
            np.testing.assert_array_equal(row[:hits[0] + 1],
                                          full[:hits[0] + 1])
            assert (row[hits[0]:] == eos).all(), row
        else:
            np.testing.assert_array_equal(row, full)
    same = np.stack([rows[2]] * 2)
    kw = dict(temperature=0.7, top_p=0.9, top_k=20, key=prng.key(5))
    sampled = TL.generate_paged(tparams, same, np.asarray([12, 12]), TCFG,
                                6, page_size=4, **kw).numpy()
    dense = TL.generate(tparams, same, TCFG, 6, **kw).numpy()[:, 12:]
    np.testing.assert_array_equal(sampled, dense)


def _pools(seed, S=3, ps=4, pps=5):
    rng = np.random.RandomState(seed)
    L, Hkv, Dh = JCFG.num_hidden_layers, JCFG.num_key_value_heads, \
        JCFG.head_dim
    P = 1 + S * pps
    kp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    tables = (1 + rng.permutation(S * pps)).reshape(S, pps).astype(np.int32)
    return kp, vp, tables


def test_serving_decode_block_matches_jax(jparams, tparams):
    """Three greedy steps for two live slots and one dead (all-trash)
    slot: live tokens equal, pools (trash page excluded) within 1e-5."""
    kp, vp, tables = _pools(2)
    tables[2] = 0
    tok = np.asarray([5, 17, 0], np.int32)
    lengths = np.asarray([7, 13, 0], np.int32)
    jt, jkp, jvp = JL.serving_decode_block(
        jparams, jnp.asarray(tok), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(kp), jnp.asarray(vp), JCFG,
        num_steps=3, attn_impl="dense")
    tkp, tvp = _t(kp), _t(vp)
    tt, tkp2, _ = TL.serving_decode_block(
        tparams, _t(tok), _t(lengths), _t(tables), tkp, tvp, TCFG,
        num_steps=3)
    assert tkp2 is tkp and tt.dtype == torch.int32 and tt.shape == (3, 3)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    for a, b in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(a.numpy()[:, :, 1:],
                                   np.asarray(b)[:, :, 1:], rtol=RTOL,
                                   atol=RTOL)


def test_serving_prefill_and_chunk_match_jax(jparams, tparams):
    """A whole 7-token prompt, then a 6-token chunk behind 2 cached
    pages: logits within rtol 1e-5, the pools' written pages too."""
    kp, vp, tables = _pools(3)
    table = tables[0]
    rng = np.random.RandomState(4)
    toks = rng.randint(0, JCFG.vocab_size, (1, 8)).astype(np.int32)
    jl, jkp, jvp = JL.serving_prefill(
        jparams, jnp.asarray(toks), jnp.int32(7), jnp.asarray(table),
        jnp.asarray(kp), jnp.asarray(vp), JCFG)
    tkp, tvp = _t(kp), _t(vp)
    tl, _, _ = TL.serving_prefill(tparams, toks, 7, table, tkp, tvp, TCFG)
    assert tl.shape == (JCFG.vocab_size,) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=RTOL)
    for a, b in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(a.numpy()[:, :, 1:],
                                   np.asarray(b)[:, :, 1:], rtol=RTOL,
                                   atol=RTOL)
    chunk = rng.randint(0, JCFG.vocab_size, (1, 8)).astype(np.int32)
    jl, jkp, _ = JL.serving_prefill_chunk(
        jparams, jnp.asarray(chunk), jnp.int32(6), jnp.asarray(table),
        jkp, jvp, JCFG, prefix_pages=2)
    tl, _, _ = TL.serving_prefill_chunk(tparams, chunk, 6, table, tkp, tvp,
                                        TCFG, prefix_pages=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(tkp.numpy()[:, :, 1:],
                               np.asarray(jkp)[:, :, 1:], rtol=RTOL,
                               atol=RTOL)


def test_generation_predictor_matches_jax(jparams, tparams):
    """generate_ragged and generate: the JAX predictor's tokens; the
    same errors."""
    prompts = [np.arange(5) % JCFG.vocab_size,
               (np.arange(11) * 7) % JCFG.vocab_size]
    jp = JPredictor(jparams, JCFG, max_len=64)
    tp = TPredictor(tparams, TCFG, max_len=64, device="cpu")
    want = jp.generate_ragged(prompts, 4, page_size=4)
    got = tp.generate_ragged(prompts, 4, page_size=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp.generate(prompts[1][None], 3),
                                  jp.generate(prompts[1][None], 3))
    for pred in (jp, tp):
        with pytest.raises(ValueError, match="max_len"):
            pred.generate_ragged(prompts, 60)
        with pytest.raises(ValueError, match="max_new_tokens"):
            pred.generate_ragged(prompts, 0)
