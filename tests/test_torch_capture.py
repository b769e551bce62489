"""Whole-function capture of the port's Llama and Qwen2-MoE paths:
``jit.to_static`` (``torch.compile`` with ``fullgraph=True``) over the
kernel entries' PyTorch operators, against the eager port and the JAX
package.

Each case captures with ``backend="aot_eager"`` (inductor takes tens of
seconds a function on this CPU; the card runs it, ``chip_smoke.py``
phase 21) and fails on any graph break. On CPU tensors the operators'
bodies run the plain versions. Contract (tiny configs, f32):

* the Llama loss with per-layer remat, and the Qwen2-MoE dropless loss:
  loss and every gradient within rtol/atol 1e-5 of JAX's
  ``value_and_grad`` (``tests/test_torch_train.py``'s contract); the
  captured forward and backward graphs hold the expected
  ``paddle_tpu.*`` nodes;
* the serving tick (page writes in place): tokens, logits and both
  pools equal the eager tick's bitwise, and the JAX tick's within 1e-5;
* the int8 paged decode step, captured once with ``n_tail`` a tensor and
  run for 6 steps: logits equal the eager step's bitwise, tokens equal
  JAX ``generate_paged``'s;
* ``lower()`` names the operators; a module over the tiny Llama forward
  saved with ``jit.save`` loads and runs in a fresh process.
"""
import collections
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)
from torch import nn

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.models import qwen2_moe as JQ
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu.quantization import decode as JD
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 16
LAYERS = 2


def _layers(cfg, n=LAYERS):
    return dataclasses.replace(cfg, num_hidden_layers=n)


def _counting_backend(counts):
    """``aot_eager`` whose forward and backward compilers count the
    graph's ``paddle_tpu.*`` nodes into ``counts["fw"]`` / ``["bw"]``."""
    from functorch.compile import make_boxed_func
    from torch._dynamo.backends.common import aot_autograd

    def compiler(kind):
        def count(gm, example_inputs):
            for n in gm.graph.nodes:
                name = str(n.target)
                if n.op == "call_function" and name.startswith("paddle_tpu."):
                    counts[kind][name.split(".")[1]] += 1
            return make_boxed_func(gm.forward)
        return count

    return aot_autograd(fw_compiler=compiler("fw"),
                        bw_compiler=compiler("bw"))


def _no_breaks(fn):
    stats = fn.graph_break_stats
    assert stats["graph_breaks"] == 0, stats


def _t(a):
    return torch.from_numpy(np.array(a))


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


@pytest.fixture(scope="module")
def mesh():
    return init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False).mesh


# ---------------------------------------------------------------------------
# training: the Llama and Qwen2-MoE losses
# ---------------------------------------------------------------------------

def test_captured_llama_loss_with_remat_matches_jax(mesh):
    jcfg = _layers(JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                                       use_flash_attention=True,
                                       use_fused_norm_rope=True))
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0))
    with mesh:
        jbatch = JL.make_batch(jcfg, B, T, mesh, key=jax.random.PRNGKey(1))
    jloss, jgrads = jax.value_and_grad(JL.loss_fn)(jparams, jbatch, jcfg)

    tcfg = _layers(TL.LlamaConfig.tiny(dtype=torch.float32, remat=True))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    state = TL.make_train_step(tcfg, device="cpu")[1](
        TL.params_from_jax(np_params, device="cpu"))
    counts = collections.defaultdict(collections.Counter)
    loss_fn = TJ.to_static(TL.loss_fn, backend=_counting_backend(counts))
    loss = loss_fn(state["params"], {k: _t(v) for k, v in jbatch.items()},
                   tcfg)
    loss.backward()
    _no_breaks(loss_fn)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = TL.params_to_numpy(_grads(state["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(_get(grads, path), np.asarray(want),
                                   err_msg=str(path), **TOL)
    # forward: 2 norms + rope + flash a layer, the final norm; backward:
    # each layer recomputed (remat) and its backward operators
    L = LAYERS
    assert counts["fw"] == {"rms_norm_fwd": 2 * L + 1, "rope": L,
                            "flash_attention_fwd": L}, counts["fw"]
    assert counts["bw"] == {
        "rms_norm_fwd": 2 * L, "rope": 2 * L, "flash_attention_fwd": L,
        "rms_norm_bwd": 2 * L + 1, "flash_attention_bwd_dq": L,
        "flash_attention_bwd_dkv": L}, counts["bw"]


def test_captured_qwen2_moe_dropless_loss_matches_jax():
    jcfg = JQ.Qwen2MoeConfig.tiny(dtype=jnp.float32, remat=True,
                                  use_flash_attention=True,
                                  moe_impl="dropless")
    jparams = JQ.init_params(jcfg, jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    toks = rs.randint(0, jcfg.vocab_size, (B, T + 1)).astype(np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.value_and_grad(JQ.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in np_batch.items()}, jcfg)

    tcfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32, remat=True,
                                  moe_impl="dropless")
    state = TQ.make_train_step(tcfg, device="cpu")[1](TQ.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    counts = collections.defaultdict(collections.Counter)
    loss_fn = TJ.to_static(TQ.loss_fn, backend=_counting_backend(counts))
    loss = loss_fn(state["params"], {k: _t(v) for k, v in np_batch.items()},
                   tcfg)
    loss.backward()
    _no_breaks(loss_fn)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = TL.params_to_numpy(_grads(state["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(_get(grads, path), np.asarray(want),
                                   err_msg=str(path), **TOL)
    # three expert gmms a layer forward; backward: each recomputed, and
    # dlhs (gmm) and drhs (tgmm) of each: 9 gmm and 3 tgmm a layer a step
    L = tcfg.num_hidden_layers
    assert counts["fw"]["gmm"] == 3 * L
    assert counts["bw"]["gmm"] == 6 * L
    assert counts["bw"]["tgmm"] == 3 * L


# ---------------------------------------------------------------------------
# serving: the tick and the int8 paged decode step
# ---------------------------------------------------------------------------

JCFG = _layers(JL.LlamaConfig.tiny(dtype=jnp.float32,
                                   use_flash_attention=False, remat=False))
TCFG = _layers(TL.LlamaConfig.tiny(dtype=torch.float32))


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


def _mixed_tick():
    """Slot 0 decodes at position 7, slot 1 prefills 5 tokens behind a
    4-token prefix, slot 2 a whole 6-token prompt; random context KV."""
    rs = np.random.RandomState(0)
    S, ps, pps = 3, 4, 6
    P = 1 + S * pps
    tables = np.arange(1, P).reshape(S, pps).astype(np.int32)
    shape = (LAYERS, JCFG.num_key_value_heads, P, ps, JCFG.head_dim)
    kp = rs.randn(*shape).astype(np.float32)
    vp = rs.randn(*shape).astype(np.float32)
    tok, meta = TL.pack_tick(
        [(0, 5, 7)], [(1, rs.randint(0, 256, 5), 4),
                      (2, rs.randint(0, 256, 6), 0)], tables, ps, "cpu")
    meta["tail_live"] = torch.tensor([True, False, True])
    return tok, meta, kp, vp


def test_captured_serving_tick_equals_eager_and_jax(jparams, tparams):
    tok, meta, kp, vp = _mixed_tick()
    ekp, evp = _t(kp), _t(vp)
    eager = TL.serving_tick(tparams, tok, meta, ekp, evp, TCFG,
                            decode_tail=2)
    tick = TJ.to_static(TL.serving_tick, backend="aot_eager")
    ckp, cvp = _t(kp), _t(vp)
    got = tick(tparams, tok, meta, ckp, cvp, TCFG, decode_tail=2)
    _no_breaks(tick)
    assert got[2] is ckp and got[3] is cvp
    for a, b in ((got[0], eager[0]), (got[1], eager[1]), (ckp, ekp),
                 (cvp, evp)):
        assert torch.equal(a, b)
    jt, jl, jkp, jvp = JL.serving_tick(
        jparams, jnp.asarray(tok.numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in meta.items()},
        jnp.asarray(kp), jnp.asarray(vp), JCFG, tq=6, decode_tail=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jt))
    for a, b in ((got[1], jl), (ckp, jkp), (cvp, jvp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_captured_int8_paged_decode_matches_eager_and_jax(jparams):
    jq = JD.quantize_for_decode(jparams, JCFG)
    tq = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                            device="cpu")
    rs = np.random.RandomState(9)
    lens = np.asarray([5, 9, 12], np.int32)
    prompt = rs.randint(0, JCFG.vocab_size, (3, 12)).astype(np.int32)
    n_new = 7
    want = JL.generate_paged(jq, jnp.asarray(prompt), jnp.asarray(lens),
                             JCFG, n_new, page_size=4)
    logits, cache = TL.prefill_paged(tq, prompt, lens, TCFG, n_new,
                                     page_size=4)
    eager = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in cache.items()}
    step = TJ.to_static(TL._decode_paged_step, backend="aot_eager")
    tok = logits.argmax(-1).int()
    toks = [tok]
    for _ in range(n_new - 1):
        want_logits = TL._decode_paged_step(tq, tok, eager, TCFG)
        got_logits = step(tq, tok, cache, TCFG)
        assert torch.equal(got_logits, want_logits)
        tok = got_logits.argmax(-1).int()
        toks.append(tok)
    _no_breaks(step)
    assert step.graph_break_stats["segments"] == 1     # one program
    assert int(cache["n_tail"]) == int(eager["n_tail"]) == n_new - 1
    assert torch.equal(cache["k_tail"], eager["k_tail"])
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.asarray(want))


def test_lower_names_the_operators(tparams):
    """``lower()`` (a ``torch.export`` graph) keeps each kernel entry one
    operator node: the train forward, the tick and the int8 decode
    step."""
    tcfg = _layers(TL.LlamaConfig.tiny(dtype=torch.float32), 1)
    fwd = TJ.to_static(lambda p, t: TL.forward(p, t, tcfg))
    params = TL.params_from_jax(TL.params_to_numpy(tparams), device="cpu")
    params["layers"] = {k: v[:1] for k, v in params["layers"].items()}
    text = fwd.lower(params, torch.zeros((1, 8), dtype=torch.int32))
    for op in ("rms_norm_fwd", "rope", "flash_attention_fwd"):
        assert f"torch.ops.paddle_tpu.{op}.default" in text, op
    assert text.count("paddle_tpu.rms_norm_fwd.default(") == 3

    tok, meta, kp, vp = _mixed_tick()
    tick = TJ.to_static(
        lambda p, t, m, a, b: TL.serving_tick(p, t, m, a, b, TCFG)[1])
    text = tick.lower(tparams, tok, meta, _t(kp), _t(vp))
    assert text.count("paddle_tpu.ragged_paged_attention_packed.default(") \
        == LAYERS


class _Forward(nn.Module):
    """The tiny Llama forward as a module: the params its buffers."""

    def __init__(self, params, cfg):
        super().__init__()
        self.cfg = cfg
        self.names = []
        for path, t in _flat(params):
            name = "__".join(path)
            self.register_buffer(name, t)
            self.names.append((path, name))

    def forward(self, tokens):
        params = {}
        for path, name in self.names:
            d = params
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = getattr(self, name)
        return TL.forward(params, tokens, self.cfg)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_saved_llama_forward_loads_in_a_fresh_process(tparams, tmp_path):
    """``jit.save`` of the tiny Llama forward (its operators in the
    program), ``jit.load`` in a process that has imported nothing of the
    kernels: the loaded program runs and equals the program run here
    bitwise, and the eager forward within 1e-5 (eager CPU attention is
    the dense reference; the program's is the flash operator's plain
    body)."""
    m = _Forward(tparams, TCFG).eval()
    path = str(tmp_path / "llama")
    TJ.save(m, path, input_spec=[TJ.InputSpec([None, 8], "int32")])
    toks = np.random.RandomState(4).randint(0, 256, (3, 8)).astype(np.int32)
    np.save(tmp_path / "toks.npy", toks)
    probe = (
        "import sys, numpy as np, torch\n"
        "from paddle_tpu_torch import jit\n"
        f"m = jit.load({path!r})\n"
        f"out = m(torch.from_numpy(np.load({str(tmp_path / 'toks.npy')!r})))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, out.numpy())\n"
        "print(sorted(k for k in sys.modules if k.startswith("
        "'paddle_tpu_torch.ops.kernels.')))\n")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=180, check=True)
    assert "paddle_tpu_torch.ops.kernels.fused_norm_rope" in res.stdout
    got = np.load(tmp_path / "out.npy")
    here = TJ.load(path)(_t(toks)).numpy()
    np.testing.assert_array_equal(got, here)
    with torch.no_grad():
        eager = m(_t(toks)).numpy()
    np.testing.assert_allclose(got, eager, **TOL)
