"""The port's MoE functional and Qwen2-MoE training path vs the JAX
package: ``top_k_gating``, ``moe_ffn`` (einsum, at a capacity that drops
tokens and at one that drops none), ``moe_ffn_dropless`` with its aux loss
and gradients, and the tiny Qwen2-MoE with ``moe_impl="dropless"`` and
remat on: forward logits and aux, the loss and every gradient, and three
``make_train_step`` steps.

Weights come from the JAX init through ``params_from_jax``, other inputs
from numpy with a seed. The JAX side runs its grouped-matmul Pallas
kernels in interpret mode and flash attention on its dense path (no
splash on the CPU), on a one-device mesh where it needs one; the port
runs its plain kernel versions (CPU tensors). Contract (tiny config,
f32): rtol/atol 1e-5; params after the three steps within rtol 1e-5,
atol 3e-5, the bound of ``tests/test_torch_train.py`` and for the same
reason (Adam's update of a gradient element near zero)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.incubate.moe import functional as JF
from paddle_tpu.models import qwen2_moe as JQ
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch.incubate.moe import functional as TF
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 16


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _moe_inputs(seed, S=32, D=16, F=24, E=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(S, D).astype(np.float32)
    gate_w = rs.randn(D, E).astype(np.float32)
    ws = [(rs.randn(*shape) * 0.1).astype(np.float32)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    return x, gate_w, ws


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("top_k,capacity", [(1, 4), (2, 6), (2, 32)])
def test_top_k_gating_matches_jax(top_k, capacity, normalize):
    logits = np.random.RandomState(top_k + capacity).randn(32, 4).astype(
        np.float32)
    want = JF.top_k_gating(jnp.asarray(logits), top_k, capacity,
                           normalize_topk=normalize)
    got = TF.top_k_gating(_t(logits), top_k, capacity,
                          normalize_topk=normalize)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("capacity_factor", [0.75, 2.0])
def test_moe_ffn_einsum_and_grads_match_jax(capacity_factor):
    """capacity_factor 0.75 drops tokens (C = 12 of 16 wanted a slot on
    average), 2.0 = E / top_k drops none."""
    x, gate_w, ws = _moe_inputs(1)
    ct = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def jfn(*a):
        y, aux = JF.moe_ffn(*a, top_k=2, capacity_factor=capacity_factor)
        return jnp.vdot(y, jnp.asarray(ct)) + aux, (y, aux)

    (_, (want, jaux)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (x, gate_w, *ws)))
    leaves = [_t(a, True) for a in (x, gate_w, *ws)]
    got, aux = TF.moe_ffn(*leaves, top_k=2, capacity_factor=capacity_factor)
    ((got * _t(ct)).sum() + aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, **TOL)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_ffn_dropless_aux_and_grads_match_jax(top_k):
    x, gate_w, ws = _moe_inputs(3 + top_k)
    ct = np.random.RandomState(4).randn(*x.shape).astype(np.float32)

    def jfn(*a):
        y, aux = JF.moe_ffn_dropless(*a, top_k=top_k)
        return jnp.vdot(y, jnp.asarray(ct)) + aux, (y, aux)

    (_, (want, jaux)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, (x, gate_w, *ws)))
    leaves = [_t(a, True) for a in (x, gate_w, *ws)]
    got, aux = TF.moe_ffn_dropless(*leaves, top_k=top_k)
    ((got * _t(ct)).sum() + aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, **TOL)


def test_dropless_equals_einsum_when_nothing_drops():
    """Within the port: the grouped-matmul path and the einsum path at
    capacity_factor = E / top_k compute the same function."""
    x, gate_w, ws = _moe_inputs(5)
    a = [_t(v) for v in (x, gate_w, *ws)]
    yd, auxd = TF.moe_ffn_dropless(*a, top_k=2)
    ye, auxe = TF.moe_ffn(*a, top_k=2, capacity_factor=2.0)
    np.testing.assert_allclose(yd.numpy(), ye.numpy(), **TOL)
    assert float(auxd) == pytest.approx(float(auxe), rel=1e-6)


def test_one_device_refusals():
    """Expert parallelism and meshes are refused; a key under moe_ffn's
    default gating policy draws nothing, as in the JAX package (the
    random policy is held to JAX in test_torch_qwen2_moe_serving.py)."""
    from paddle_tpu_torch import prng
    x, gate_w, ws = _moe_inputs(6)
    a = [_t(v) for v in (x, gate_w, *ws)]
    for got, want in zip(TF.moe_ffn(*a, key=prng.key(3)), TF.moe_ffn(*a)):
        assert torch.equal(got, want)
    with pytest.raises(NotImplementedError):
        TF.moe_ffn(*a, ep_axis="ep")
    cfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        TQ.make_train_step(cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="moe_impl"):
        TQ.forward({}, torch.zeros(1, 2, dtype=torch.int32),
                   TQ.Qwen2MoeConfig.tiny(moe_impl="sparse"))


# ---------------------------------------------------------------------------
# tiny Qwen2-MoE, dropless, remat on
# ---------------------------------------------------------------------------

def _jcfg(**kw):
    return JQ.Qwen2MoeConfig.tiny(dtype=jnp.float32, remat=True,
                                  use_flash_attention=True, **kw)


def _tcfg(**kw):
    return TQ.Qwen2MoeConfig.tiny(dtype=torch.float32, remat=True, **kw)


@pytest.fixture(scope="module")
def mesh():
    return init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False).mesh


@pytest.fixture(scope="module")
def setup():
    cfg = _jcfg(moe_impl="dropless")
    jparams = JQ.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    np_batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return cfg, jparams, np_params, np_batch


def _tbatch(np_batch):
    return {k: _t(v) for k, v in np_batch.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("moe_impl", ["dropless", "einsum"])
def test_forward_logits_and_aux_match_jax(setup, moe_impl):
    _, jparams, np_params, np_batch = setup
    cfg = _jcfg(moe_impl=moe_impl)
    want, jaux = JQ.forward(jparams, jnp.asarray(np_batch["tokens"]), cfg)
    with torch.no_grad():
        got, aux = TQ.forward(TQ.params_from_jax(np_params, device="cpu"),
                              _tbatch(np_batch)["tokens"],
                              _tcfg(moe_impl=moe_impl))
    assert got.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def test_loss_and_every_grad_match_jax(setup):
    """value_and_grad(loss_fn) with remat: the port's per-layer leaves
    (nested expert and shared-expert dicts too) get the stacked JAX
    gradients, layer by layer."""
    cfg, jparams, np_params, np_batch = setup
    jloss, jgrads = jax.value_and_grad(JQ.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in np_batch.items()}, cfg)
    tcfg = _tcfg(moe_impl="dropless")
    state = TQ.make_train_step(tcfg, device="cpu")[1](
        TQ.params_from_jax(np_params, device="cpu"))
    loss = TQ.loss_fn(state["params"], _tbatch(np_batch), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = TL.params_to_numpy(_grads(state["params"]))
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(_get(grads, path), np.asarray(want),
                                   err_msg=str(path), **TOL)


def test_train_params_are_nested_per_layer_leaves(setup):
    _, _, np_params, _ = setup
    state = TQ.make_train_step(_tcfg(), device="cpu")[1](
        TQ.params_from_jax(np_params, device="cpu"))
    layers = state["params"]["layers"]
    assert len(layers) == 2
    for lp in layers:
        assert set(lp["experts"]) == {"w_gate", "w_up", "w_down"}
        assert lp["router"].dtype == torch.float32
        for v in TL._tree_leaves(lp):
            assert v.is_leaf and v.requires_grad
    back = TL.params_to_numpy(state["params"])
    for path, want in jax.tree_util.tree_leaves_with_path(np_params):
        np.testing.assert_array_equal(_get(back, path), want)


def test_three_train_steps_match_jax(setup, mesh):
    """The slice as a whole: three dropless steps on one fixed batch,
    loss trajectory and final params against the JAX train step
    (optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1))."""
    cfg, _, np_params, np_batch = setup
    with mesh:
        jstep, jinit = JQ.make_train_step(cfg, mesh)
        jstate = jinit(jax.random.PRNGKey(0))
        jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
        jlosses = []
        for _ in range(3):
            jstate, jl = jstep(jstate, jbatch)
            jlosses.append(float(jl))
        jfinal = jax.tree_util.tree_map(np.asarray, jstate["params"])

    step, init = TQ.make_train_step(_tcfg(moe_impl="dropless"),
                                    device="cpu")
    state = init(TQ.params_from_jax(np_params, device="cpu"))
    batch = _tbatch(np_batch)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert state["step"] == 3 and losses[2] < losses[0]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got = TL.params_to_numpy(state["params"])
    for path, want in jax.tree_util.tree_leaves_with_path(jfinal):
        np.testing.assert_allclose(_get(got, path), want,
                                   err_msg=str(path), rtol=1e-5, atol=3e-5)


def test_init_params_shapes_and_batch():
    cfg = _tcfg()
    p = TQ.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    E, D = cfg.num_experts, cfg.hidden_size
    assert p["layers"]["experts"]["w_down"].shape == (
        2, E, cfg.moe_intermediate_size, D)
    assert p["layers"]["router"].dtype == torch.float32
    assert p["layers"]["shared"]["gate"].shape == (2, D, 1)
    b = TQ.make_batch(cfg, 2, 8, device="cpu")
    assert b["tokens"].shape == (2, 8)
