"""The port's pipeline executors on a Llama vs the JAX package's, loss and
every gradient on the same mesh: pp 2 and pp 4 under GPipe, lockstep
1F1B, rank-asymmetric 1F1B and zero bubble (M 4), M 5 at pp 2, and
interleaved VPP 2 at pp 2.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``) runs every
case; its rank bodies live in ``tests/_torch_pipe_ranks.py`` (torch,
numpy and the port only). The JAX references run here on the conftest's
8-device CPU mesh while the world runs: GPipe's is
``value_and_grad(loss_fn)``, the fused schedules' the lockstep
``grads_1f1b`` of the geometry (the JAX package's own tests hold its
async schedules to it). ``LlamaConfig.tiny``, f32, T 16, weights from
JAX ``init_params``, batches from JAX ``make_batch``; the JAX side runs
``use_flash_attention=False`` as its pipeline tests do.

Contract, the JAX pipeline tests' (``tests/test_pipeline_async.py``
:173-174): loss rtol 1e-6 / atol 1e-7, every gradient rtol 2e-5 / atol
1e-6. Within the port: lockstep 1f1b and 1f1b_async give the same bits
(the same per-op math, f32 sums in microbatch order); zb too (W takes
the same gradients from B's kept graph). The p2p counters equal the
exchanges of the schedule's op table; under bf16 the sums are f32, the
messages bf16 and each gradient is cast once.
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

T = 16
FUSED = ("1f1b", "1f1b_async", "zb")
# (geometry, pp, M, V, B, schedules, first rank): the pp 2 geometries
# run on ranks 0-1 and 2-3 at once, then pp 4 on all four
GEOMS = [("pp2_m4", 2, 4, 1, 4, ("gpipe",) + FUSED, 0),
         ("pp2_m5", 2, 5, 1, 5, FUSED, 2),
         ("pp2_m4_v2", 2, 4, 2, 4, ("1f1b", "1f1b_async"), 2),
         ("pp4_m4", 4, 4, 1, 4, ("gpipe",) + FUSED, 0)]
CASES = [(f"{g}_{s}", 1, pp, 1,
          dict(pp_schedule=s, num_microbatches=M, vpp_chunks=V), g, first)
         for g, pp, M, V, _, scheds, first in GEOMS for s in scheds]
NAMES = [c[0] for c in CASES]
FIRST = {c[0]: c[6] for c in CASES}


def _jcfg(pp=1, sched="gpipe", M=1, V=1):
    return JL.LlamaConfig.tiny(
        dtype=jnp.float32, remat=False, use_flash_attention=False,
        pp_stages=pp, num_microbatches=M, pp_schedule=sched, vpp_chunks=V)


def _jax_ref(g, pp, M, V, np_params, np_batch, gpipe):
    hm = init_hybrid_mesh(dp=1, pp=pp, tp=1, set_global=False)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    with hm.mesh:
        if gpipe:
            cfg = _jcfg(pp, "gpipe", M, V)
            loss, grads = jax.jit(lambda p, b: jax.value_and_grad(
                JL.loss_fn)(p, b, cfg, hm.mesh))(params, batch)
        else:
            cfg = _jcfg(pp, "1f1b", M, V)
            loss, grads = jax.jit(lambda p, b: JL.grads_1f1b(
                p, b, cfg, hm.mesh))(params, batch)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs():
    """The world and the JAX references, the world running while JAX
    compiles."""
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(_jcfg(), jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    batches = {}
    with hm.mesh:
        for g, _, _, _, B, _, _ in GEOMS:
            b = JL.make_batch(_jcfg(), B, T, hm.mesh,
                              key=jax.random.PRNGKey(1))
            batches[g] = {k: np.asarray(v) for k, v in b.items()}
    ctx = dist.spawn(ranks.grad_cases, (np_params, batches, CASES),
                     nprocs=4, join=False)
    try:
        want = {}
        for g, pp, M, V, _, scheds, _ in GEOMS:
            if "gpipe" in scheds:
                want[(g, True)] = _jax_ref(g, pp, M, V, np_params,
                                           batches[g], True)
            want[(g, False)] = _jax_ref(g, pp, M, V, np_params, batches[g],
                                        False)
    finally:
        world = ctx.join(timeout_s=120)
    return world, want


def _tree_close(got, want, rtol, atol, what):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        x = got
        for k in path:
            x = x[k.key]
        np.testing.assert_allclose(x, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax_on_the_same_mesh(runs, name):
    world, want = runs
    g = next(c[5] for c in CASES if c[0] == name)
    wl, wg = want[(g, name.endswith("gpipe"))]
    got = world[FIRST[name]]["cases"][name]
    np.testing.assert_allclose(got["loss"], wl, rtol=1e-6, atol=1e-7)
    _tree_close(got["grads"], wg, 2e-5, 1e-6, name)
    # the loss is the global mean on every rank of the pipeline
    for w in world:
        if name in w["cases"]:
            assert w["cases"][name]["loss"] == got["loss"]


def _same_bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


@pytest.mark.parametrize("g", [g[0] for g in GEOMS])
def test_fused_schedules_give_the_same_bits(runs, g):
    """Lockstep 1f1b = 1f1b_async bitwise; zb the same bits where the
    geometry runs it."""
    cases = runs[0][FIRST[f"{g}_1f1b_async"]]["cases"]
    ref = cases[f"{g}_1f1b_async"]
    for s in ("1f1b", "zb"):
        if f"{g}_{s}" in cases:
            got = cases[f"{g}_{s}"]
            assert got["loss"] == ref["loss"], (g, s)
            assert _same_bits(got["grads"], ref["grads"]), (g, s)


def _table_p2p(sched, r, nbytes):
    """Rank ``r``'s p2p from the op table: its F (not F+head) and B (not
    the embedding's) ops send one message each; every stored arrival is
    one received; ``recv`` counts one call a tick with any message."""
    k = sched.kind[:, r]
    sends = int(((k == 1) | ((k == 2) & (sched.emit[:, r] == 0))).sum())
    got = (sched.store_up[:, r] >= 0) | (sched.store_dn[:, r] >= 0)
    ticks = int((got | (k == 1) | ((k == 2) & (sched.emit[:, r] == 0)))
                .sum())
    return {"send": {"calls": sends, "bytes": sends * nbytes},
            "recv": {"calls": ticks, "bytes": int(got.sum()) * nbytes}}


@pytest.mark.parametrize("name", [n for n in NAMES if "async" in n
                                  or n.endswith("_zb")])
def test_p2p_equals_the_op_tables_exchanges(runs, name):
    world = runs[0]
    _, _, pp, _, kw, g, _ = next(c for c in CASES if c[0] == name)
    M, V = kw["num_microbatches"], kw["vpp_chunks"]
    variant = "zb" if kw["pp_schedule"] == "zb" else "1f1b"
    sched = build_schedule(pp, M, V, variant)
    nbytes = T * 64 * 4          # one [mb 1, T, D] f32 message
    for w in world:
        rec = w["cases"].get(name)
        if rec is not None:
            want = _table_p2p(sched, rec["pp"], nbytes)
            got = {k: {f: v[f] for f in ("calls", "bytes")}
                   for k, v in rec["p2p"].items()}
            assert got == want, (name, rec["pp"], got, want)


def test_f32_sums_under_bf16(runs):
    """The structural pin of ``test_fp32_grad_accum_pinned_under_bf16``:
    under bf16 the schedule's gradient sums are f32, the messages
    between stages bf16, and each returned gradient is its f32 sum
    scaled by 1/M and cast to bf16 once."""
    for w in runs[0][:2]:
        pin = w["bf16"]
        assert pin["sum_dtypes"] == ["torch.float32"]
        assert pin["grad_dtypes"] == ["torch.bfloat16"]
        assert pin["cast_once"]
        s = pin["p2p"]["send"]
        assert s["calls"] > 0 and s["bytes"] == s["calls"] * T * 64 * 2
