"""The port's pipeline train step composed with dp and tp vs the JAX
package's ``make_train_step`` on the same mesh, in the geometries of
``tests/test_pipeline_async.py::test_composed_matches_lockstep``: dp 2 x
pp 2 (M 4 and M 5) and tp 2 x pp 2 (M 4, and interleaved VPP 2), three
steps each; and a dp 2 x tp 2 x pp 2 zb step on the mesh ``fleet.init``
builds from its ``pp_degree``, against one-stage autodiff. ZeRO under a
pipeline and the refusals: ``tests/test_torch_pipeline_zero.py``.

One spawned gloo world of 8 CPU ranks (``distributed.spawn``) runs every
port case, the dp 2 ones on ranks 0-3 while the tp 2 ones run on ranks
4-7; its rank bodies live in ``tests/_torch_pipe_ranks.py``. The JAX
steps run here on the conftest's 8-device CPU mesh while the world
runs, each geometry under ``1f1b_async`` (the JAX package's tests hold
its zb to its 1f1b schedules at 1e-6). ``LlamaConfig.tiny``, f32, T 16
(T 32 for the one-stage case), weights from JAX ``init_params``,
batches from JAX ``make_batch``.

Contract: the train steps as ``tests/test_torch_parallel_train.py``
holds the dp x tp ones (losses rtol 1e-5, params after three steps
rtol 1e-5 / atol 3e-5); the one-stage comparison at
``tests/test_pipeline_async.py`` :196-197 (loss rtol 1e-5 / atol 1e-6,
gradients rtol 2e-4 / atol 1e-5).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_pipe_ranks as ranks
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu.parallel.pipeline_async import build_schedule
from paddle_tpu_torch import distributed as dist

T, STEPS = 16, 3
# geometry -> (dp, tp, M, V, B, first rank)
GEOMS = {"dp2_m4": (2, 1, 4, 1, 8, 0), "tp2_m4": (1, 2, 4, 1, 4, 4),
         "dp2_m5": (2, 1, 5, 1, 10, 0), "tp2_m4_v2": (1, 2, 4, 2, 4, 4)}
# (name, geometry, schedule)
RUNS = [("dp2_m4_zb", "dp2_m4", "zb"),
        ("dp2_m4_async", "dp2_m4", "1f1b_async"),
        ("dp2_m5_zb", "dp2_m5", "zb"),
        ("tp2_m4_zb", "tp2_m4", "zb"),
        ("tp2_m4_async", "tp2_m4", "1f1b_async"),
        ("tp2_m4_v2_async", "tp2_m4_v2", "1f1b_async")]
CASES = [(name, GEOMS[g][0], 2, GEOMS[g][1], 0,
          dict(pp_schedule=s, num_microbatches=GEOMS[g][2],
               vpp_chunks=GEOMS[g][3]), g, GEOMS[g][5])
         for name, g, s in RUNS]
GRAD_CASE = (dict(pp_schedule="zb", num_microbatches=4), "3d")


def _jcfg(pp=1, sched="gpipe", M=1, V=1):
    return JL.LlamaConfig.tiny(
        dtype=jnp.float32, remat=False, use_flash_attention=False,
        pp_stages=pp, num_microbatches=M, pp_schedule=sched, vpp_chunks=V)


def jax_steps(dp, tp, M, V, z, np_batch):
    """JAX ``make_train_step`` under 1f1b_async on a (dp, pp 2, tp)
    mesh at ZeRO ``z``: the losses of ``STEPS`` steps and the params."""
    hm = init_hybrid_mesh(dp=dp, pp=2, tp=tp, set_global=False)
    with hm.mesh:
        step, init = JL.make_train_step(_jcfg(2, "1f1b_async", M, V),
                                        hm.mesh, zero_stage=z)
        state = init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, state["params"])


def _jax_one_stage(np_params, np_batch):
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    cfg = _jcfg()
    with hm.mesh:
        loss, grads = jax.jit(lambda p, b: jax.value_and_grad(JL.loss_fn)(
            p, b, cfg, hm.mesh))(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            {k: jnp.asarray(v) for k, v in np_batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs():
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(_jcfg(), jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    batches = {}
    with hm.mesh:
        for g, (_, _, _, _, B, _) in GEOMS.items():
            b = JL.make_batch(_jcfg(), B, T, hm.mesh,
                              key=jax.random.PRNGKey(1))
            batches[g] = {k: np.asarray(v) for k, v in b.items()}
        b = JL.make_batch(_jcfg(), 8, 2 * T, hm.mesh,
                          key=jax.random.PRNGKey(2))
        batches["3d"] = {k: np.asarray(v) for k, v in b.items()}
    ctx = dist.spawn(ranks.train_cases,
                     (np_params, batches, CASES, STEPS, GRAD_CASE),
                     nprocs=8, join=False)
    try:
        want = {g: jax_steps(*GEOMS[g][:4], 0, batches[g]) for g in GEOMS}
        want["3d"] = _jax_one_stage(np_params, batches["3d"])
    finally:
        world = ctx.join(timeout_s=120)
    return world, want


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("name,g,sched", RUNS)
def test_three_steps_match_jax_on_the_same_mesh(runs, name, g, sched):
    world, want = runs
    want_losses, want_params = want[g]
    got = world[GEOMS[g][5]]["cases"][name]
    assert got["losses"][2] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    for path, w in jax.tree_util.tree_leaves_with_path(want_params):
        np.testing.assert_allclose(_get(got["params"], path), w,
                                   err_msg=f"{name} {path}", rtol=1e-5,
                                   atol=3e-5)
    # every rank of the mesh returns the global mean loss
    recs = [w["cases"][name] for w in world if name in w["cases"]]
    assert len(recs) == 2 * GEOMS[g][0] * GEOMS[g][1]
    assert all(r["losses"] == got["losses"] for r in recs)


def test_p2p_is_the_schedules_per_dp_row(runs):
    """At dp 2 x pp 2 each dp row runs its own schedule: every rank's
    sends are its column's F and B messages of [mb/dp, T, D] f32."""
    world = runs[0]
    sched = build_schedule(2, 4, 1, "zb")
    for w in world:
        rec = w["cases"].get("dp2_m4_zb")
        if rec is None:
            continue
        k = sched.kind[:, rec["pp"]]
        msgs = int(((k == 1) | ((k == 2) & (sched.emit[:, rec["pp"]] == 0)))
                   .sum())
        assert rec["p2p"]["send"]["calls"] == STEPS * msgs
        assert rec["p2p"]["send"]["bytes"] == STEPS * msgs * 1 * T * 64 * 4


def test_fleet_pp_degree_trains_3d_zb_against_one_stage_autodiff(runs):
    """``fleet.init`` with ``pp_degree`` 2 (dp 2, mp 2) gives the dp 2 x
    pp 2 x tp 2 mesh; a zb step there equals plain one-stage
    ``value_and_grad`` (the embedding and the vocab-parallel head
    included)."""
    world, want = runs
    assert world[0]["fleet_shape"] == {"dp": 2, "pp": 2, "tp": 2}
    wl, wg = want["3d"]
    got = world[0]["fleet_3d"]
    np.testing.assert_allclose(got["loss"], wl, rtol=1e-5, atol=1e-6)
    for path, w in jax.tree_util.tree_leaves_with_path(wg):
        np.testing.assert_allclose(_get(got["grads"], path), w, rtol=2e-4,
                                   atol=1e-5, err_msg=str(path))
    assert all(w["fleet_3d"]["loss"] == got["loss"] for w in world)
