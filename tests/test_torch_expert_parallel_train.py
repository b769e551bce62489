"""The port's Qwen2-MoE train step under expert parallelism vs the JAX
package's ``make_train_step`` on the same mesh: dp 2 x ep 2 x tp 2
(``tests/test_moe.py``'s), ep 4, and dp 2 x ep 2 at capacity_factor 0.5
(tokens dropped) with router_aux_loss_coef 0.5 (the aux gradient's
weight under dp shows), three steps each, with ``forward`` and
``loss_fn`` on each mesh before training.

One spawned gloo world of 8 CPU ranks (``distributed.spawn``; rank bodies
in ``tests/_torch_ep_ranks.py``) runs every case while the JAX steps run
here on the conftest's 8-device CPU mesh. Weights come from JAX
``init_params`` through numpy, the batch from JAX ``make_batch``.
Contract (tiny config, f32, remat on): losses within rtol 1e-5, params
within rtol 1e-5 / atol 3e-5 (the bound of ``tests/test_torch_train.py``:
Adam's first updates are +-lr where a gradient is within rounding of
zero), logits and aux within 1e-5. Beside them: every replicated leaf
is bitwise equal across the ep peers of a rank after the three steps
(the expert leaves differ), ``fleet.init(ep_degree=2)`` trains,
dropless on a sharded mesh runs the einsum path, and the refusals."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_ep_ranks as ranks
import _torch_threads  # noqa: F401
from paddle_tpu.models import qwen2_moe as JQ
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist

B, T, STEPS = 4, 16, 3
DROP = dict(capacity_factor=0.5, router_aux_loss_coef=0.5)
# (name, mesh, Qwen2MoeConfig kwargs); ep 4 on ranks 0-3 runs beside the
# dropping dp 2 x ep 2 on ranks 4-7
CASES = [
    ("dp2_ep2_tp2", dict(dp=2, ep=2, tp=2), {}),
    ("ep4", dict(ep=4, ranks=(0, 1, 2, 3)), {}),
    ("dp2_ep2_drop", dict(dp=2, ep=2, ranks=(4, 5, 6, 7)), DROP),
]
NAMES = [c[0] for c in CASES]


def _jcfg(**kw):
    return JQ.Qwen2MoeConfig.tiny(dtype=jnp.float32, remat=True,
                                  use_flash_attention=True, **kw)


def jax_run(shape, cfg_kw, np_params, np_batch):
    """JAX on the mesh: forward's logits and aux and ``loss_fn`` at the
    initial params, then ``make_train_step``'s losses and final
    params."""
    cfg = _jcfg(**cfg_kw)
    shape = {k: v for k, v in shape.items() if k != "ranks"}
    hm = init_hybrid_mesh(**shape, set_global=False)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    with hm.mesh:
        p = JQ.shard_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                            cfg, hm.mesh)
        logits, aux = jax.jit(lambda p, t: JQ.forward(p, t, cfg, hm.mesh))(
            p, batch["tokens"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: JQ.loss_fn(p, b, cfg, hm.mesh)))(p, batch)
        step, init = JQ.make_train_step(cfg, hm.mesh)
        state = init(jax.random.PRNGKey(0))
        losses = []
        for _ in range(STEPS):
            state, value = step(state, batch)
            losses.append(float(value))
        return {"logits": np.asarray(logits), "aux": float(aux),
                "loss_fn": float(loss), "losses": losses,
                "grads": jax.tree_util.tree_map(np.asarray, grads),
                "params": jax.tree_util.tree_map(np.asarray,
                                                 state["params"])}


@pytest.fixture(scope="module")
def runs():
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JQ.init_params(cfg, jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(set_global=False)
    with hm.mesh:
        # the batch of tests/test_moe.py's mesh step (make_batch's key)
        b = JQ.make_batch(cfg, B, T, hm.mesh)
    np_batch = {k: np.asarray(v) for k, v in b.items()}
    ctx = dist.spawn(ranks.train_cases, (np_params, np_batch, CASES, STEPS),
                     nprocs=8, join=False)
    try:
        want = {name: jax_run(shape, kw, np_params, np_batch)
                for name, shape, kw in CASES}
    finally:
        world = ctx.join(timeout_s=300)
    return world, want


def _recs(world, name):
    return [w["cases"][name] for w in world if name in w["cases"]]


def _shape(name):
    return next(s for n, s, _ in CASES if n == name)


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_fn_match_jax(runs, name):
    """Each rank's logits are the JAX logits' block of its dp rows and
    vocab shard; the aux loss (the global batch's) and ``loss_fn`` (its
    rows' mean NLL plus the aux term, averaged over dp) are JAX's."""
    world, want = runs
    w = want[name]
    shape = _shape(name)
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)
    n, v = B // dp, w["logits"].shape[-1] // tp
    recs = _recs(world, name)
    assert len(recs) == dp * shape.get("ep", 1) * tp
    for r in recs:
        i, j = r["coords"]["dp"], r["coords"]["tp"]
        np.testing.assert_allclose(
            r["logits"], w["logits"][i * n:(i + 1) * n, :, j * v:(j + 1) * v],
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["aux"], w["aux"], rtol=1e-5, atol=1e-6)
    mean = np.mean([r["loss_fn"] for r in recs])
    np.testing.assert_allclose(mean, w["loss_fn"], rtol=1e-5)


def _walk(want, got):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        yield jax.tree_util.keystr(path), g, leaf


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(runs, name):
    """The step's gradient at the initial params (each rank's loss
    backward, averaged over dp, gathered) is JAX's ``grad(loss_fn)`` on
    the mesh, every leaf within rtol 1e-5 / atol 1e-6 (f32 rounding,
    summed over the step's products, reads ~1e-7 at the gradients' 4e-2
    scale): the expert, router and aux terms with
    their dp, ep and tp reductions, before Adam's update, which moves an
    element whose gradient is within rounding of zero by up to +-lr."""
    world, want = runs
    got = next(r["grads"] for r in _recs(world, name) if "grads" in r)
    for path, g, leaf in _walk(want[name]["grads"], got):
        np.testing.assert_allclose(g, leaf, rtol=1e-5, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_jax(runs, name):
    """Three steps: every rank's losses equal, within rtol 1e-5 of JAX's;
    the gathered params within rtol 1e-5 / atol 3e-5."""
    world, want = runs
    recs = _recs(world, name)
    for r in recs[1:]:
        assert r["losses"] == recs[0]["losses"]
    np.testing.assert_allclose(recs[0]["losses"], want[name]["losses"],
                               rtol=1e-5)
    got = next(r["params"] for r in recs if "params" in r)
    assert len(jax.tree_util.tree_leaves(want[name]["params"])) == len(
        jax.tree_util.tree_leaves(got))
    for path, g, leaf in _walk(want[name]["params"], got):
        np.testing.assert_allclose(g, leaf, rtol=1e-5, atol=3e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_leaves_bitwise_across_ep(runs, name):
    """ep peers hold the same tokens: after three steps every leaf the
    specs replicate over ep is bitwise equal across them, while each
    holds different experts."""
    world, _ = runs
    recs = _recs(world, name)
    by = {}
    for r in recs:
        c = r["coords"]
        by.setdefault((c["dp"], c["tp"]), []).append(r)
    for peers in by.values():
        assert len(peers) == _shape(name)["ep"]
        a = peers[0]["local"]
        for b in peers[1:]:
            for k, v in a.items():
                if ranks._replicated(k):
                    assert np.array_equal(v, b["local"][k]), k
                else:
                    assert v.shape == b["local"][k].shape
                    assert not np.array_equal(v, b["local"][k]), k


def test_capacity_drops_are_global(runs):
    """At capacity_factor 0.5 the gating drops (token, slot) assignments
    of the global batch, the same count on every rank; at 2.0 = E / top_k
    it drops none."""
    world, _ = runs
    for name in NAMES:
        recs = _recs(world, name)
        counts = recs[0]["dropped"]
        assert len(counts) == 2
        assert all(r["dropped"] == counts for r in recs)
        if name == "dp2_ep2_drop":
            assert all(c > 0 for c in counts), counts
        else:
            assert counts == [0.0, 0.0], counts


def test_fleet_ep_degree_trains(runs):
    """``fleet.init`` with ep_degree 2 (dp the rest of the world) builds
    the dp 4 x ep 2 mesh, and a seeded Qwen2-MoE step on it trains: every
    rank's losses equal, finite and falling."""
    world, _ = runs
    f = world[0]["fleet"]
    assert f["shape"] == {"dp": 4, "pp": 1, "ep": 2, "tp": 1}
    for w in world:
        assert w["fleet"]["losses"] == f["losses"]
    assert np.isfinite(f["losses"]).all()
    assert f["losses"][-1] < f["losses"][0]


def test_refusals_and_dropless_rule(runs):
    """pp or cp on Qwen raise NotImplementedError; E % ep and F % tp
    raise ValueError, as does the strict grouped-matmul kernel on a
    sharded mesh; ``moe_impl="dropless"`` on a dp mesh runs the einsum
    path (JAX's rule)."""
    world, _ = runs
    w = world[0]
    assert w["pp"].startswith("NotImplementedError: Qwen2-MoE trains over "
                              "dp x ep x tp; pp=2")
    assert w["cp"].startswith("NotImplementedError: Qwen2-MoE trains over "
                              "dp x ep x tp; pp=1 and cp=2")
    assert w["uneven_experts"].startswith(
        "ValueError: the mesh does not divide experts=4 over 8")
    assert w["uneven_ffn"].startswith(
        "ValueError: the mesh does not divide moe_intermediate_size=33")
    assert w["dropless_kernel"].startswith(
        "ValueError: use_grouped_matmul='kernel' on a mesh")
    einsum, dropless = w["dropless_on_dp"]
    assert einsum == dropless
