"""Weight-only int8 decode of the PyTorch port vs the JAX package.

``ops.fused.int8_matmul`` (quantization and the int8 product),
``quantization.decode`` and the int8 decode paths (``generate``,
``generate_paged``, ``ServingEngine(quantization="int8")``). The JAX int8
kernel runs as its own tests run it on the CPU: ``int8_matmul_pallas``
in interpret mode. Contract (tiny config, f32, CPU): quantization
bitwise (q and scale); the product within rtol 1e-5 in f32 and one bf16
ulp at each row's output scale in bf16; greedy tokens equal exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.ops.fused.int8_matmul import (
    quantize_weight_per_channel as j_quantize)
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul_pallas
from paddle_tpu.quantization import decode as JQ
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.fused.int8_matmul import (
    Int8Weight, int8_weight_matmul, quantize_weight_per_channel)
from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
    tiled_ulp_error)
from paddle_tpu_torch.quantization import decode as TQ
from paddle_tpu_torch.serving import ServingEngine

JCFG = JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                           remat=False)
TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jqparams(jparams):
    return JQ.quantize_for_decode(jparams, JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(_np_tree(jparams), device="cpu")


@pytest.fixture(scope="module")
def tqparams(jqparams):
    return TL.params_from_jax(_np_tree(jqparams), device="cpu")


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_is_bitwise_jax(shape):
    """q and scale bitwise, for a matrix and a layer stack; values that
    land on .5 round half to even in both."""
    rng = np.random.RandomState(0)
    w = rng.randn(*shape).astype(np.float32)
    w[..., 0, 0] = 127.0            # channel 0's scale becomes exactly 1
    w[..., 1, 0] = 2.5
    w[..., 2, 0] = -3.5
    jq, js = j_quantize(jnp.asarray(w))
    tq, ts = quantize_weight_per_channel(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tq[(0,) * (len(shape) - 2) + (1, 0)]) == 2
    assert int(tq[(0,) * (len(shape) - 2) + (2, 0)]) == -4


# (M, K, N): rows on both sides of the card kernel's regime edges (64
# rows an item up to M = 64, parts spread across blocks up to M = 256) at
# two tileable weight shapes; the first case keeps the bare dtype id
INT8_PARITY_CASES = [(5, 256, 384), (1, 256, 384), (64, 256, 384),
                     (65, 256, 384), (256, 256, 384), (5, 1024, 512),
                     (65, 1024, 512)]


@pytest.mark.parametrize(
    "dtype,M,K,N",
    [(dt, *c) for c in INT8_PARITY_CASES for dt in ("float32", "bfloat16")],
    ids=[dt if c == INT8_PARITY_CASES[0] else f"{dt}-M{c[0]}-K{c[1]}-N{c[2]}"
         for c in INT8_PARITY_CASES for dt in ("float32", "bfloat16")])
def test_int8_matmul_matches_jax_pallas_kernel(dtype, M, K, N):
    """The port's product (the kernel's plain version on the CPU) vs the
    JAX Pallas kernel in interpret mode at tileable shapes."""
    rng = np.random.RandomState(1)
    x = rng.randn(M, K).astype(np.float32)
    # the weight as initialised (unit-scale outputs, so the absolute
    # tolerance means the same at every K)
    w = rng.randn(K, N) / np.sqrt(K)
    q, s = j_quantize(jnp.asarray(w.astype(np.float32)))
    jx = jnp.asarray(x, dtype)
    want = int8_matmul_pallas(jx, q, s)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = int8_weight_matmul(tx, torch.from_numpy(np.asarray(q)),
                             torch.from_numpy(np.asarray(s)))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        ulps = tiled_ulp_error(got, np.asarray(want.astype(jnp.float32)),
                               eps=torch.finfo(torch.bfloat16).eps)
        assert ulps <= 1.0, ulps


def test_quantize_for_decode_matches_jax(tparams, jqparams, tqparams):
    """The port quantizes the JAX params to the JAX bits; it quantizes the
    projections and lm_head only; quantizing twice raises; the decode
    weight bytes agree; dequantize gives the dense approximation."""
    got = TQ.quantize_for_decode(tparams, TCFG)
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w, ref = got["layers"][k], tqparams["layers"][k]
        assert isinstance(w, Int8Weight) and isinstance(ref, Int8Weight)
        assert torch.equal(w.q, ref.q) and torch.equal(w.scale, ref.scale)
    assert torch.equal(got["lm_head"].q, tqparams["lm_head"].q)
    for k in ("attn_norm", "mlp_norm"):
        assert got["layers"][k] is tparams["layers"][k]
    assert got["embed"] is tparams["embed"]
    assert TQ.is_quantized_params(got) and not TQ.is_quantized_params(
        tparams)
    with pytest.raises(ValueError, match="already"):
        TQ.quantize_for_decode(got, TCFG)
    assert TQ.decode_weight_bytes(got) == JQ.decode_weight_bytes(jqparams)
    assert TQ.decode_weight_bytes(tparams) == JQ.decode_weight_bytes(
        JQ.dequantize_for_decode(jqparams, jnp.float32))
    deq = TQ.dequantize_for_decode(got, torch.float32)
    w = deq["layers"]["wq"]
    assert w.dtype == torch.float32
    err = (w - tparams["layers"]["wq"]).abs().max()
    assert float(err) <= float(got["layers"]["wq"].scale.max()) / 2 + 1e-6
    lw = got["layers"]["wq"][1]           # indexing slices both leaves
    assert lw.shape == tparams["layers"]["wq"][1].shape
    assert lw.scale.shape == (w.shape[-1],)


@pytest.mark.parametrize("lens", [[6, 6], [5, 9, 12]],
                         ids=["equal", "ragged"])
def test_generate_paged_int8_matches_jax_exactly(jqparams, tqparams, lens):
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, JCFG.vocab_size,
                         (len(lens), max(lens))).astype(np.int32)
    want = JL.generate_paged(jqparams, jnp.asarray(prompt),
                             jnp.asarray(lens, jnp.int32), JCFG, 8,
                             page_size=4)
    got = TL.generate_paged(tqparams, prompt, np.asarray(lens), TCFG, 8,
                            page_size=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_pins_inside_the_port(tparams, tqparams):
    """Paged int8 equals dense int8; int8 stays near full precision
    (the JAX package's bounds: max |dlogit| < 0.2 x logit spread, greedy
    match >= 0.5 on these near-uniform random logits)."""
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, JCFG.vocab_size, (2, 6)).astype(np.int32)
    paged = TL.generate_paged(tqparams, prompt, np.asarray([6, 6]), TCFG,
                              8, page_size=4)
    dense = TL.generate(tqparams, prompt, TCFG, 8)[:, 6:]
    np.testing.assert_array_equal(paged.numpy(), dense.numpy())
    lg_fp, _ = TL.forward_with_cache(
        tparams, torch.from_numpy(prompt),
        TL.init_kv_cache(TCFG, 2, 8, "cpu"), 0, TCFG)
    lg_q, _ = TL.forward_with_cache(
        tqparams, torch.from_numpy(prompt),
        TL.init_kv_cache(TCFG, 2, 8, "cpu"), 0, TCFG)
    err = float((lg_fp - lg_q).abs().max())
    assert err < 0.2 * max(float(lg_fp.std()), 1.0), err
    full = TL.generate(tparams, prompt, TCFG, 12)[:, 6:]
    quant = TL.generate(tqparams, prompt, TCFG, 12)[:, 6:]
    assert float((full == quant).float().mean()) >= 0.5


def test_serving_engine_int8_matches_jax_generate_int8(jqparams, tparams):
    """ServingEngine(quantization="int8") quantizes dense params at
    construction; its tokens equal JAX generate() on the JAX-quantized
    params."""
    prompts = [[1, 2, 3], [7, 5], [11, 12, 13, 14]]
    gen = jax.jit(lambda p, t: JL.generate(p, t, JCFG, max_new_tokens=8))
    refs = [np.asarray(gen(jqparams, jnp.asarray(p)[None]))[0, len(p):]
            for p in prompts]
    eng = ServingEngine(tparams, TCFG, device="cpu", quantization="int8",
                        max_batch=4, page_size=4, max_prompt_len=16,
                        max_new_tokens_cap=16)
    try:
        assert TQ.is_quantized_params(eng._params)
        handles = [eng.submit(p, max_new_tokens=8) for p in prompts]
        for h, ref in zip(handles, refs):
            np.testing.assert_array_equal(np.asarray(h.result(timeout=120)),
                                          ref)
    finally:
        eng.close()
    with pytest.raises(ValueError, match="quantization"):
        ServingEngine(tparams, TCFG, device="cpu", quantization="fp8")
