"""PyTorch port of the Llama serving slice vs the JAX package.

Weights come from the JAX init (``paddle_tpu.models.llama.init_params``)
through ``params_from_jax``; inputs are seeded numpy arrays handed to
both. Contract (tiny config, f32, CPU): the serving tick's tokens equal,
its logits and both pools within rtol/atol 1e-5; greedy ``generate``
tokens equal exactly.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import llama as TL

JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(_np_tree(jparams), device="cpu")


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_params_from_jax_is_exact(dtype):
    """Every leaf keeps its shape, its dtype and its exact values (bf16
    goes through f32, which is exact)."""
    jp = _np_tree(JL.init_params(JL.LlamaConfig.tiny(dtype=dtype),
                                 jax.random.PRNGKey(0)))
    tp = TL.params_from_jax(jp, device="cpu")
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == want and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_init_params_layout_and_scale():
    """The port's own init: the JAX layouts and dtypes, normal ·
    1/sqrt(fan_in), norms at one, reproducible from the generator."""
    cfg = TL.LlamaConfig.tiny()
    a = TL.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = TL.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = JL.abstract_params(JL.LlamaConfig.tiny())
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        ta, tb = a, b
        for k in path:
            ta, tb = ta[k.key], tb[k.key]
        assert tuple(ta.shape) == leaf.shape and ta.dtype == torch.bfloat16
        assert torch.equal(ta, tb)
    for name, fan_in in (("wq", 64), ("w_down", 128)):
        std = a["layers"][name].float().std().item()
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)
    assert torch.equal(a["final_norm"], torch.ones(64, dtype=torch.bfloat16))
    assert torch.equal(a["layers"]["attn_norm"],
                       torch.ones(4, 64, dtype=torch.bfloat16))


def _mixed_tick(S=3, ps=4, pps=6, seed=0):
    """One mixed tick's packed stream (numpy): slot 0 decodes at position
    7 over a 7-token context, slot 1 prefills tokens 4..8 behind a
    4-token cached prefix (stays mid-prompt), slot 2 prefills a whole
    6-token prompt; the idle decode positions of slots 1-2 are padding.
    Pools hold random context KV."""
    rng = np.random.RandomState(seed)
    P = 1 + S * pps
    tables = np.arange(1, P).reshape(S, pps).astype(np.int32)
    L, Hkv, Dh = JCFG.num_hidden_layers, JCFG.num_key_value_heads, \
        JCFG.head_dim
    kp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    vp = rng.randn(L, Hkv, P, ps, Dh).astype(np.float32)
    spans = [(1, 4, 5), (2, 0, 6)]            # (slot, start, take)
    T = S + sum(t for _, _, t in spans)
    tok = rng.randint(0, JCFG.vocab_size, (T,)).astype(np.int32)
    tok_slot = np.full((T,), S, np.int32)
    tok_pos = np.zeros((T,), np.int32)
    tok_qoff = np.zeros((T,), np.int32)
    tok_slot[0], tok_pos[0] = 0, 7
    q_len = np.asarray([1, 0, 0], np.int32)
    kv_len = np.asarray([8, 0, 0], np.int32)
    last = np.zeros((S,), np.int32)
    idx = S
    for slot, start, take in spans:
        tok_slot[idx:idx + take] = slot
        tok_pos[idx:idx + take] = np.arange(start, start + take)
        tok_qoff[idx:idx + take] = np.arange(take)
        q_len[slot], kv_len[slot] = take, start + take
        last[slot] = idx + take - 1
        idx += take
    real = tok_slot < S
    tok_page = np.where(real, tables[np.minimum(tok_slot, S - 1),
                                     tok_pos // ps], 0).astype(np.int32)
    tok_off = np.where(real, tok_pos % ps, 0).astype(np.int32)
    meta = dict(tok_slot=tok_slot, tok_pos=tok_pos, tok_page=tok_page,
                tok_off=tok_off, tok_qoff=tok_qoff, q_len=q_len,
                kv_len=kv_len, last=last, tables=tables,
                tail_live=np.asarray([True, False, True]))
    return tok, meta, kp, vp


def test_serving_tick_matches_jax(jparams, tparams):
    """One mixed tick (prefill spans + decode + padding) with
    decode_tail=2: tokens equal; logits and both pools (updated in place
    by the port) within 1e-5."""
    tok, meta, kp, vp = _mixed_tick()
    jt, jl, jkp, jvp = JL.serving_tick(
        jparams, jnp.asarray(tok), {k: jnp.asarray(v) for k, v in
                                    meta.items()},
        jnp.asarray(kp), jnp.asarray(vp), JCFG, tq=6, decode_tail=2)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tt, tl, tkp2, tvp2 = TL.serving_tick(
        tparams, torch.from_numpy(tok),
        {k: torch.from_numpy(v) for k, v in meta.items()}, tkp, tvp, TCFG,
        decode_tail=2)
    assert tkp2 is tkp and tvp2 is tvp
    assert tt.shape == (3, 3) and tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tkp.numpy(), np.asarray(jkp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), rtol=1e-5,
                               atol=1e-5)


def test_pack_tick_matches_hand_packing():
    """``pack_tick`` (the engine's packing) builds the mixed tick above
    exactly as packed by hand, and sends a position past the table to
    the trash page."""
    tok, meta, _, _ = _mixed_tick()
    S, ps = 3, 4
    got_tok, got = TL.pack_tick(
        [(0, tok[0], 7)], [(1, tok[S:S + 5], 4), (2, tok[S + 5:], 0)],
        meta["tables"], ps, "cpu")
    np.testing.assert_array_equal(
        got_tok.numpy(), np.where(meta["tok_slot"] < S, tok, 0))
    assert sorted(got) == sorted(k for k in meta if k != "tail_live")
    for k, v in got.items():
        assert v.dtype == torch.int32, k
        np.testing.assert_array_equal(v.numpy(), meta[k], err_msg=k)
    pps = meta["tables"].shape[1]
    _, past = TL.pack_tick([(0, 1, pps * ps)], [], meta["tables"], ps,
                           "cpu")
    assert int(past["tok_page"][0]) == 0
    assert int(past["kv_len"][0]) == pps * ps + 1


def test_serving_tick_block_matches_jax(jparams, tparams):
    """The fused decode block: three greedy steps for two live slots and
    one dead (all-trash) slot."""
    _, meta, kp, vp = _mixed_tick(seed=1)
    tables = meta["tables"].copy()
    tables[2] = 0
    tok = np.asarray([5, 17, 0], np.int32)
    lengths = np.asarray([7, 9, 0], np.int32)
    jt, jkp, _ = JL.serving_tick_block(
        jparams, jnp.asarray(tok), jnp.asarray(lengths),
        jnp.asarray(tables), jnp.asarray(kp), jnp.asarray(vp), JCFG,
        num_steps=3)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tt, _, _ = TL.serving_tick_block(
        tparams, torch.from_numpy(tok), torch.from_numpy(lengths),
        torch.from_numpy(tables), tkp, tvp, TCFG, num_steps=3)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    np.testing.assert_allclose(tkp.numpy()[:, :, 1:], np.asarray(jkp)[
        :, :, 1:], rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_generate(n):
    return jax.jit(lambda p, t: JL.generate(p, t, JCFG, max_new_tokens=n))


def test_generate_matches_jax_exactly(jparams, tparams):
    """Greedy generate(): the port's tokens equal the JAX package's."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(_jax_generate(8)(jparams, jnp.asarray(prompt)))
    got = TL.generate(tparams, prompt, TCFG, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_latch(tparams):
    """After EOS every later position repeats EOS."""
    prompt = np.asarray([[5, 9, 2, 11]], np.int32)
    full = TL.generate(tparams, prompt, TCFG, 8).numpy()[0, 4:]
    eos = int(full[2])
    got = TL.generate(tparams, prompt, TCFG, 8,
                      eos_token_id=eos).numpy()[0, 4:]
    first = int(np.argmax(full == eos))
    np.testing.assert_array_equal(got[:first + 1], full[:first + 1])
    assert (got[first:] == eos).all()
