"""The port's dp x tp Llama train step over ``torch.distributed`` vs the
JAX package's ``make_train_step`` on the same mesh: meshes (dp, tp) =
(2, 1), (1, 2), (2, 2) at ZeRO 0, three steps each.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``) runs every
case; its rank bodies live in ``tests/_torch_dist_ranks.py`` (torch,
numpy and the port only). The JAX steps run here on the conftest's
8-device CPU mesh. Weights come from ``llama.init_params`` through
numpy, the batch from JAX ``make_batch``. Contract (tiny config, f32):
the loss trajectory within rtol 1e-5 and the params after it within
rtol 1e-5, atol 3e-5 (the one-device contract of
``tests/test_torch_train.py``). The ZeRO stages are held in
``tests/test_torch_parallel_zero.py``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_dist_ranks as ranks
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist

B, T, STEPS = 4, 16, 3
# the last case runs the unfused norm and rope (the "f" op on the norm
# weights) on both sides
UNFUSED = {"use_fused_norm_rope": False}
CASES = [("dp2", 2, 1, 0), ("tp2", 1, 2, 0), ("dp2_tp2", 2, 2, 0),
         ("tp2_unfused", 1, 2, 0, UNFUSED)]


def _jcfg(**kw):
    kw.setdefault("use_fused_norm_rope", True)
    return JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                               use_flash_attention=True, **kw)


def jax_run(dp, tp, zero_stage, np_batch, cfg_kw=None):
    """JAX ``make_train_step`` on a (dp, tp) mesh: losses and params."""
    hm = init_hybrid_mesh(dp=dp, pp=1, tp=tp, set_global=False)
    with hm.mesh:
        step, init = JL.make_train_step(_jcfg(**(cfg_kw or {})), hm.mesh,
                                        zero_stage=zero_stage)
        state = init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, state["params"])


@pytest.fixture(scope="module")
def inputs():
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(cfg, jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    with hm.mesh:
        b = JL.make_batch(cfg, B, T, hm.mesh, key=jax.random.PRNGKey(1))
    return np_params, {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def runs(inputs):
    """The port's world and the JAX steps, the world running while JAX
    compiles."""
    np_params, np_batch = inputs
    ctx = dist.spawn(ranks.train_cases,
                     (np_params, np_batch, CASES, STEPS, True), nprocs=4,
                     join=False)
    try:
        want = {c[0]: jax_run(*c[1:4], np_batch, *c[4:]) for c in CASES}
    finally:
        world = ctx.join(timeout_s=300)
    return world, want


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("name,dp,tp,stage", [c[:4] for c in CASES])
def test_three_steps_match_jax_on_the_same_mesh(runs, name, dp, tp, stage):
    world, jax_runs = runs
    want_losses, want = jax_runs[name]
    got = world[0]["cases"][name]
    assert got["losses"][2] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    for path, w in _leaves(want):
        np.testing.assert_allclose(_get(got["params"], path), w,
                                   err_msg=f"{name} {path}", rtol=1e-5,
                                   atol=3e-5)


@pytest.mark.parametrize("name,dp,tp,stage", [c[:4] for c in CASES])
def test_every_rank_returns_the_global_mean_loss(world, name, dp, tp, stage):
    """The loss is the global mean, the same on every rank of the mesh;
    the ranks sit where JAX's devices sit on the (dp, tp) grid."""
    recs = [w["cases"][name] for w in world if name in w["cases"]]
    assert len(recs) == dp * tp
    for r in recs[1:]:
        assert r["losses"] == recs[0]["losses"]
    want = np.arange(dp * tp).reshape(dp, 1, tp)
    for w in world:
        if name in w["cases"]:
            assert want[w["cases"][name]["coords"]] == w["rank"]


def test_tp_collectives_are_sequence_parallel(world):
    """At tp 2 the stream is sequence-sharded: per layer and step the
    forward all-gathers and reduce-scatters twice, the remat recompute
    again (it stops after the last tensor the backward needs, so without
    the layer's last reduce-scatter), the backward the reverse; the
    vocab-parallel cross entropy all-reduces three [B, T] statistics,
    the sharded norms their dw."""
    L = 4
    s = world[0]["cases"]["tp2"]["stats"]
    # forward 2L, recompute 2L, each reduce-scatter's backward (2L and
    # the embedding's), the final norm's gather
    assert s["all_gather"]["calls"] == STEPS * (6 * L + 2)
    # forward 2L, recompute L, each gather's backward (2L and the final
    # norm's), the embedding's
    assert s["reduce_scatter"]["calls"] == STEPS * (5 * L + 2)
    # 3 CE statistics, 2 norm dw a layer and the final norm's
    assert s["all_reduce"]["calls"] == STEPS * (3 + 2 * L + 1)
    # no dp axis: no gradient all-reduce (only [B, T] and [D] tensors)
    assert s["all_reduce"]["bytes"] == STEPS * (3 * B * T * 4
                                                + (2 * L + 1) * 64 * 4)


def test_refusals(world):
    """A sequence tp does not divide raises ValueError; a pipeline axis
    raises NotImplementedError naming the later slice; kv heads tp does
    not divide raise as the JAX async stage functions do."""
    assert world[0]["odd_T"].startswith("ValueError: sequence length 15")
    assert world[0]["pp"].startswith("NotImplementedError: pipeline")
    assert world[0]["kv_heads"].startswith(
        "ValueError: tp=4 does not divide {'kv_heads': 2}")
