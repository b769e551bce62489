"""Sharded train-state checkpoints across ranks: save, resume and reshard.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; rank bodies
in ``tests/_torch_ckpt_ranks.py``) trains four steps at dp 2 x tp 2 ZeRO
1 and 3, at pp 2 x dp 2 under ``1f1b`` and, for Qwen2-MoE, at dp 2 x ep
2; each saves after step 2 (async, while step 3 updates the state in
place) and resumes from that checkpoint into a state drawn from other
weights. Step k's batch comes from ``seed + k``. Held here:

* the resumed steps' losses and params equal the uninterrupted run's
  bitwise, and the loaded state equals the saved one bitwise (ZeRO 1's
  moments and the tp and expert shards are different values under one
  name on different ranks: a writer keeping one copy a name fails this);
* the dp 2 x tp 2 ZeRO 1 checkpoint loads into one device, into tp 4
  and into dp 4 ZeRO 3 with ``gather_params`` bitwise the saver's;
* the run against the JAX package's ``make_train_step`` on the same
  dp 2 x tp 2 ZeRO 1 mesh and batches, at the parallel tests' contract
  (losses rtol 1e-5; ``tests/test_torch_parallel_zero.py``)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_ckpt_ranks as ranks
from paddle_tpu.models import llama as JL
from paddle_tpu.models import qwen2_moe as JQ
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist

B, T, SEED = 4, 16, 52
NAMES = [c[0] for c in ranks.CASES]


def _jcfg():
    return dataclasses.replace(
        JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                            use_flash_attention=True,
                            use_fused_norm_rope=True),
        num_key_value_heads=4)


def _batches(vocab):
    out = []
    for s in range(4):
        rng = np.random.default_rng(SEED + s)
        toks = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1].copy(),
                    "labels": toks[:, 1:].copy()})
    return out


def jax_losses(batches):
    hm = init_hybrid_mesh(dp=2, pp=1, tp=2, set_global=False)
    with hm.mesh:
        step, init = JL.make_train_step(_jcfg(), hm.mesh, zero_stage=1)
        state = init(jax.random.PRNGKey(0))
        losses = []
        for b in batches:
            state, loss = step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(cfg, jax.random.PRNGKey(0)))
    np_qparams = jax.tree_util.tree_map(
        np.asarray, JQ.init_params(JQ.Qwen2MoeConfig.tiny(
            dtype=jnp.float32), jax.random.PRNGKey(0)))
    batches = _batches(cfg.vocab_size)
    root = str(tmp_path_factory.mktemp("ckpt"))
    ctx = dist.spawn(ranks.ckpt_cases, (np_params, np_qparams, batches,
                                        root), nprocs=4, join=False)
    try:
        want = jax_losses(batches)
    finally:
        world = ctx.join(timeout_s=300)
    return world, want


def _same(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y), p


@pytest.mark.parametrize("name", NAMES)
def test_resume_is_bitwise(runs, name):
    rec = runs[0][0]["cases"][name]
    assert rec["at"] == 2 and rec["step"] == 2 and rec["count"] == 2
    _same(rec["loaded"], rec["saved"])
    assert rec["resumed"] == rec["losses"][2:]
    _same(rec["resumed_params"], rec["final"])


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_resumes_to_the_same_losses(runs, name):
    recs = [w["cases"][name] for w in runs[0]]
    for r in recs:
        assert r["resumed"] == recs[0]["resumed"] == recs[0]["losses"][2:]


@pytest.mark.parametrize("target", ["one_device", "tp4", "dp4_z3"])
def test_reshard_into_another_mesh_is_bitwise(runs, target):
    z1 = runs[0][0]["cases"]["z1"]
    got = runs[0][0]["reshard"][target]
    assert got["at"] == 2 and got["step"] == 2 and got["count"] == 2
    _same(got["params"], z1["saved"])


def test_resumed_losses_match_jax(runs):
    world, want = runs
    z1 = world[0]["cases"]["z1"]
    np.testing.assert_allclose(z1["losses"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z1["resumed"], want[2:], rtol=1e-5,
                               atol=1e-5)
