"""ZeRO 1-3 over dp inside each pipeline stage, and the pipeline's
refusals, against the JAX package.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``) trains
dp 2 x pp 2 (``1f1b_async``, M 4, B 8) three steps at ZeRO 0, 1, 2 and
3; its rank bodies live in ``tests/_torch_pipe_ranks.py``. JAX
``make_train_step`` runs the same at ZeRO 1 and 3 here on the
conftest's 8-device CPU mesh while the world runs (ZeRO 0 is held in
``tests/test_torch_pipeline_hybrid.py``). ``LlamaConfig.tiny``, f32,
T 16, weights from JAX ``init_params``, the batch from JAX
``make_batch``.

Contract: each stage's losses rtol 1e-5 and params after three steps
rtol 1e-5 / atol 3e-5 of JAX's (as the dp x tp steps); ZeRO 1-3 the
same bits as the port's ZeRO 0, moments (and at 3 the params) halved
at rest, no whole-gradient all-reduce at 2-3. The refusals raise the
JAX package's errors.
"""
import numpy as np
import pytest
import torch

import jax

import _torch_pipe_ranks as ranks
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu.parallel.pipeline_1f1b import split_chunks_round_robin
from paddle_tpu.parallel.pipeline_async import build_schedule
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import HybridMesh

from test_torch_pipeline_hybrid import _get, _jcfg, jax_steps

T, STEPS, M, B = 16, 3, 4, 8
KW = dict(pp_schedule="1f1b_async", num_microbatches=M, vpp_chunks=1)
CASES = [(f"z{z}", 2, 2, 1, z, KW, "b", 0) for z in range(4)]


@pytest.fixture(scope="module")
def runs():
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(_jcfg(), jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    with hm.mesh:
        b = JL.make_batch(_jcfg(), B, T, hm.mesh, key=jax.random.PRNGKey(1))
    batch = {k: np.asarray(v) for k, v in b.items()}
    ctx = dist.spawn(ranks.train_cases,
                     (np_params, {"b": batch}, CASES, STEPS), nprocs=4,
                     join=False)
    try:
        want = {z: jax_steps(2, 1, M, 1, z, batch) for z in (1, 3)}
    finally:
        world = ctx.join(timeout_s=120)
    return world, want


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_steps_match_jax_at_the_same_stage(runs, stage):
    world, want = runs
    want_losses, want_params = want[stage]
    got = world[0]["cases"][f"z{stage}"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    for path, w in jax.tree_util.tree_leaves_with_path(want_params):
        np.testing.assert_allclose(_get(got["params"], path), w,
                                   err_msg=f"ZeRO {stage} {path}",
                                   rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_are_stage_0_bitwise_inside_each_stage(runs, stage):
    """The same losses and parameters, bit for bit, as ZeRO 0; moments
    (and at 3 the params) halved at rest; no whole-gradient all-reduce
    at 2-3 (the loss's two scalars a step only: over pp, then dp)."""
    world = runs[0]
    ref = world[0]["cases"]["z0"]
    got = world[0]["cases"][f"z{stage}"]
    assert got["losses"] == ref["losses"]
    for path, w in jax.tree_util.tree_leaves_with_path(ref["params"]):
        assert np.array_equal(_get(got["params"], path), w), path
    for w in world:
        r0, r = w["cases"]["z0"], w["cases"][f"z{stage}"]
        assert r["moment_bytes"] * 2 == r0["moment_bytes"]
        assert r["param_bytes"] * (2 if stage == 3 else 1) == \
            r0["param_bytes"]
        ar = r["all_reduce"]["bytes"]
        if stage >= 2:
            assert ar == STEPS * 2 * 4, (stage, r["all_reduce"])
        else:
            assert ar > STEPS * 2 * 4 + r0["param_bytes"], r["all_reduce"]


def _mesh(**shape):
    shape = {"dp": 1, "pp": 1, **shape, "tp": shape.get("tp", 1)}
    n = int(np.prod(list(shape.values())))
    return HybridMesh(shape, list(range(n)), {}, 0)


REFUSALS = [
    ("cp_with_pp", dict(pp_stages=2), _mesh(pp=2, cp=2),
     NotImplementedError, "context_parallel with pp_stages > 1"),
    ("zb_with_vpp", dict(pp_stages=2, pp_schedule="zb", vpp_chunks=2,
                         num_microbatches=4), _mesh(pp=2),
     ValueError, "ZB-V"),
    ("bad_schedule", dict(pp_stages=2, pp_schedule="zb_async"), _mesh(pp=2),
     ValueError, "pp_schedule"),
    ("layers_over_chunks", dict(pp_stages=2, pp_schedule="1f1b",
                                vpp_chunks=3, num_microbatches=2),
     _mesh(pp=2), ValueError, "not divisible by stages\\*chunks 6"),
    ("ep_with_pp", dict(pp_stages=2), _mesh(pp=2, ep=2),
     NotImplementedError, "expert \\(ep\\) parallelism"),
    ("stages_vs_mesh", dict(pp_stages=4), _mesh(pp=2),
     ValueError, "pp_stages=4 but the mesh's pp axis is 2"),
]


@pytest.mark.parametrize("name,kw,mesh,exc,match", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_as_the_jax_package(name, kw, mesh, exc, match):
    """The port raises where the JAX package does, with its reason:
    cp with pp; zb with V > 1 (``schedule_legality``); an unknown
    ``pp_schedule``; layers the stages' chunks do not divide. A live ep
    axis still raises, and so does a mesh whose pp is not the
    config's."""
    cfg = TL.LlamaConfig.tiny(dtype=torch.float32, **kw)
    with pytest.raises(exc, match=match):
        TL.make_train_step(cfg, mesh=mesh, device="cpu")
    if name == "zb_with_vpp":
        with pytest.raises(ValueError, match=match):
            build_schedule(2, 4, 2, "zb")
    if name == "bad_schedule":
        hm = init_hybrid_mesh(dp=1, pp=2, tp=1, set_global=False)
        with pytest.raises(ValueError, match=match):
            JL.make_train_step(_jcfg(2, "zb_async"), hm.mesh)
        with pytest.raises(ValueError, match=match):
            TL.make_train_step(cfg, device="cpu")
    if name == "layers_over_chunks":
        with pytest.raises(ValueError, match=match):
            split_chunks_round_robin({"w": np.zeros((4, 2))}, 4, 2, 3)
