"""ZeRO stages 0-3 of the port's Llama train step at dp 2 vs the JAX
package's ``make_train_step(cfg, mesh, zero_stage)``.

One spawned gloo world of 2 CPU ranks (``distributed.spawn``; rank
bodies in ``tests/_torch_dist_ranks.py``) trains each stage three steps
on one (dp 2, tp 1) mesh; the JAX steps run here on the conftest's CPU
mesh, while the world runs. Contract (tiny config, f32): losses rtol
1e-5, params rtol 1e-5 / atol 3e-5 against JAX's same stage; with two
ranks each gradient is a sum of two terms, so every stage's params and
losses equal stage 0's bitwise. State bytes at rest and the collective
counters are checked the way ``tests/test_zero_sharding.py`` checks
JAX's layouts and HLO."""
import numpy as np
import pytest

import jax

import _torch_dist_ranks as ranks
from paddle_tpu_torch import distributed as dist
from test_torch_parallel_train import (B, STEPS, T, _get, _jcfg, _leaves,
                                       jax_run)
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh

STAGES = [(f"z{k}", 2, 1, k) for k in range(4)]


@pytest.fixture(scope="module")
def runs():
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(cfg, jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False)
    with hm.mesh:
        b = JL.make_batch(cfg, B, T, hm.mesh, key=jax.random.PRNGKey(1))
    np_batch = {k: np.asarray(v) for k, v in b.items()}
    ctx = dist.spawn(ranks.train_cases, (np_params, np_batch, STAGES, STEPS),
                     nprocs=2, join=False)
    try:
        want = {name: jax_run(dp, tp, k, np_batch)
                for name, dp, tp, k in STAGES}
    finally:
        world = ctx.join(timeout_s=300)
    return world, want


def _case(runs, name, rank=0):
    return runs[0][rank]["cases"][name]


@pytest.mark.parametrize("name,dp,tp,stage", STAGES)
def test_stage_matches_jax_stage(runs, name, dp, tp, stage):
    want_losses, want = runs[1][name]
    got = _case(runs, name)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    for path, w in _leaves(want):
        np.testing.assert_allclose(_get(got["params"], path), w,
                                   err_msg=f"{name} {path}", rtol=1e-5,
                                   atol=3e-5)


@pytest.mark.parametrize("name", ["z1", "z2", "z3"])
def test_stage_params_bitwise_equal_stage_zero(runs, name):
    base, got = _case(runs, "z0"), _case(runs, name)
    assert got["losses"] == base["losses"]
    for path, w in _leaves(base["params"]):
        assert np.array_equal(_get(got["params"], path), w), (name, path)


@pytest.mark.parametrize("rank", [0, 1])
def test_state_bytes_at_rest_shrink_by_dp(runs, rank):
    """Stage >= 1 halves the moments on each rank, stage 3 the params
    too (every tiny leaf has a dp-divisible dim)."""
    b = {k: _case(runs, k, rank) for k in ("z0", "z1", "z2", "z3")}
    for k in ("z1", "z2", "z3"):
        assert b[k]["moment_bytes"] * 2 == b["z0"]["moment_bytes"], k
    for k in ("z1", "z2"):
        assert b[k]["param_bytes"] == b["z0"]["param_bytes"], k
    assert b["z3"]["param_bytes"] * 2 == b["z0"]["param_bytes"]


def test_stage2_reduce_scatters_gradients(runs):
    """Stage 0 and 1 all-reduce every gradient whole; stages 2 and 3
    reduce-scatter them into the slice and all-reduce only the loss."""
    p_bytes = _case(runs, "z0")["param_bytes"]
    for k in ("z0", "z1"):
        s = _case(runs, k)["stats"]
        assert s["all_reduce"]["bytes"] == STEPS * (p_bytes + 4), k
        assert "reduce_scatter" not in s, k
    for k in ("z2", "z3"):
        s = _case(runs, k)["stats"]
        assert s["all_reduce"]["bytes"] == STEPS * 4, k
        assert s["reduce_scatter"]["bytes"] == STEPS * p_bytes, k


def test_stage3_all_gathers_params_at_use_within_the_jax_bound(runs):
    """Stage 3 gathers each layer's params at use twice a step (forward
    and the remat recompute) and the others once: above stage 0's
    gathers, within ``tests/test_zero_sharding.py``'s bound of 4 x param
    bytes + stage 0's a step. Stages 1 and 2 gather the updated params
    once a step."""
    p_bytes = _case(runs, "z0")["param_bytes"]
    cfg = _jcfg()
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    qd = cfg.num_attention_heads * cfg.head_dim
    kd = cfg.num_key_value_heads * cfg.head_dim
    layer = 4 * (2 * D * qd + 2 * D * kd + 3 * D * F + 2 * D)
    b0 = _case(runs, "z0")["stats"].get("all_gather", {"bytes": 0})["bytes"]
    b3 = _case(runs, "z3")["stats"]["all_gather"]["bytes"]
    assert b0 == 0
    assert b3 == STEPS * (2 * L * layer + (p_bytes - L * layer))
    assert b0 < b3 <= STEPS * 4 * p_bytes + b0
    for k in ("z1", "z2"):
        assert _case(runs, k)["stats"]["all_gather"]["bytes"] == \
            STEPS * p_bytes
