"""The port's training path vs the JAX package: forward logits, the
loss and its gradients with per-layer remat, and three train steps.

Weights come from the JAX init through ``params_from_jax``; the batch
from JAX ``make_batch``, handed over as numpy. The JAX side runs its
usual configuration (fused rmsnorm/rope Pallas kernels in interpret
mode, flash attention on its dense path since splash does not run on the
CPU, remat on) on a one-device mesh, as ``bench.py`` builds it; the port
runs its plain kernel versions (CPU tensors). Contract (tiny config,
f32): logits, loss and gradients within rtol/atol 1e-5; the three-step
loss trajectory within 1e-5 and the params after it within rtol 1e-5,
atol 3e-5 = lr / 10. Adam divides each moment by its own root second
moment plus eps = 1e-8, so where a gradient element is within a few eps
of zero a 1e-5 relative difference in it moves that element's update by
more than 1e-5 (measured: 1 element of 32,768 in ``w_up`` off by
1.5e-5); a tenth of one update still fails any wrong update."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch.models import llama as TL

TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 16


def _jcfg(**kw):
    return JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                               use_flash_attention=True,
                               use_fused_norm_rope=True, **kw)


TCFG = TL.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def mesh():
    return init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False).mesh


@pytest.fixture(scope="module")
def setup(mesh):
    cfg = _jcfg()
    jparams = JL.init_params(cfg, jax.random.PRNGKey(0))
    with mesh:
        jbatch = JL.make_batch(cfg, B, T, mesh, key=jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    np_batch = {k: np.asarray(v) for k, v in jbatch.items()}
    return cfg, jparams, np_params, np_batch


def _tbatch(np_batch):
    return {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_forward_logits_match_jax(setup):
    cfg, jparams, np_params, np_batch = setup
    want = JL.forward(jparams, jnp.asarray(np_batch["tokens"]), cfg)
    tparams = TL.params_from_jax(np_params, device="cpu")
    with torch.no_grad():
        got = TL.forward(tparams, _tbatch(np_batch)["tokens"], TCFG)
    assert got.shape == (B, T, TCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(setup, remat):
    """value_and_grad(loss_fn): the port's per-layer leaves get the
    stacked JAX gradients, layer by layer."""
    cfg, jparams, np_params, np_batch = setup
    jloss, jgrads = jax.value_and_grad(JL.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in np_batch.items()}, cfg)
    tcfg = TL.LlamaConfig.tiny(dtype=torch.float32, remat=remat)
    state = TL.make_train_step(tcfg, device="cpu")[1](
        TL.params_from_jax(np_params, device="cpu"))
    params = state["params"]
    loss = TL.loss_fn(params, _tbatch(np_batch), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    grads = TL.params_to_numpy(
        {"embed": params["embed"].grad, "final_norm":
         params["final_norm"].grad, "lm_head": params["lm_head"].grad,
         "layers": [{k: v.grad for k, v in lp.items()}
                    for lp in params["layers"]]})
    for path, want in _leaves(jgrads):
        np.testing.assert_allclose(_get(grads, path), np.asarray(want),
                                   err_msg=str(path), **TOL)


def test_train_params_are_per_layer_leaves(setup):
    """Each layer's weights are leaves of their own (no stacked leaf the
    layers select from), and the round trip to numpy is exact."""
    _, _, np_params, _ = setup
    state = TL.make_train_step(TCFG, device="cpu")[1](
        TL.params_from_jax(np_params, device="cpu"))
    layers = state["params"]["layers"]
    assert len(layers) == TCFG.num_hidden_layers
    for lp in layers:
        for v in lp.values():
            assert v.is_leaf and v.requires_grad
    back = TL.params_to_numpy(state["params"])
    for path, want in _leaves(np_params):
        np.testing.assert_array_equal(_get(back, path), want)
    assert state["step"] == 0 and state["opt"]["count"] == 0


def test_three_train_steps_match_jax(setup, mesh):
    """The slice as a whole: three steps of ``make_train_step`` on one
    fixed batch, loss trajectory and final params against the JAX train
    step (optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1))."""
    cfg, _, np_params, np_batch = setup
    with mesh:
        jstep, jinit = JL.make_train_step(cfg, mesh)
        jstate = jinit(jax.random.PRNGKey(0))
        jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
        jlosses = []
        for _ in range(3):
            jstate, jl = jstep(jstate, jbatch)
            jlosses.append(float(jl))
        jfinal = jax.tree_util.tree_map(np.asarray, jstate["params"])

    step, init = TL.make_train_step(TCFG, device="cpu")
    state = init(TL.params_from_jax(np_params, device="cpu"))
    batch = _tbatch(np_batch)
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert state["step"] == 3 and state["opt"]["count"] == 3
    assert losses[2] < losses[0]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got = TL.params_to_numpy(state["params"])
    for path, want in _leaves(jfinal):
        np.testing.assert_allclose(_get(got, path), want,
                                   err_msg=str(path), rtol=1e-5, atol=3e-5)


def test_make_batch_and_step_refusals():
    b = TL.make_batch(TCFG, 2, 8, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    assert b["tokens"].shape == (2, 8) and b["tokens"].dtype == torch.int32
    full = torch.cat([b["tokens"], b["labels"][:, -1:]], 1)
    assert torch.equal(full[:, 1:], b["labels"])
    assert int(b["tokens"].max()) < TCFG.vocab_size
    with pytest.raises(NotImplementedError):
        TL.make_train_step(TCFG, device="cpu", zero_stage=1)
    with pytest.raises(NotImplementedError):
        TL.make_train_step(TCFG, device="cpu", mesh=object())
