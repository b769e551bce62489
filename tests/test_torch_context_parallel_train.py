"""The port's Llama train step under context parallelism vs the JAX
package's ``make_train_step`` on the same mesh: cp 2 x tp 2 ring at ZeRO
0, dp 2 x cp 2 zigzag at ZeRO 1 and cp 2 Ulysses, three steps each, with
``forward`` and ``loss_fn`` on each mesh before training.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; rank bodies
in ``tests/_torch_cp_ranks.py``) runs every case while the JAX steps run
here on the conftest's 8-device CPU mesh. Weights come from JAX
``init_params`` through numpy, the batch from JAX ``make_batch``.
Contract (tiny config, f32; the dp x tp one of
``tests/test_torch_parallel_train.py``): losses within rtol 1e-5, params
within rtol 1e-5 / atol 3e-5, logits within 1e-5. Beside them: the
zigzag loss equals the contiguous one, the fused rope sees the zigzag
positions, ``fleet.init(sep_degree=2)`` trains, and the refusals."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import _torch_cp_ranks as ranks
import _torch_threads  # noqa: F401
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.parallel import context_parallel as CP

B, T, STEPS = 4, 16, 3
# (name, mesh, zero stage, LlamaConfig kwargs); the unfused zigzag case
# runs on ranks 2-3 beside Ulysses on ranks 0-1
CASES = [
    ("cp2_tp2_ring", dict(cp=2, tp=2), 0, {"context_parallel": "ring"}),
    ("dp2_cp2_zigzag", dict(dp=2, cp=2), 1, {"context_parallel": "zigzag"}),
    ("cp2_ulysses", dict(cp=2), 0, {"context_parallel": "ulysses"}),
    ("cp2_zigzag_unfused", dict(cp=2), 0,
     {"context_parallel": "zigzag", "use_fused_norm_rope": False}),
]
RANKS = {"cp2_ulysses": (0, 1), "cp2_zigzag_unfused": (2, 3)}
JAX_CASES = CASES[:3]


def _jcfg(**kw):
    kw.setdefault("use_fused_norm_rope", True)
    return JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                               use_flash_attention=True, **kw)


def _nll(logits, labels):
    """Mean next-token cross entropy in f64 (JAX ``loss_fn``'s value on
    its logits)."""
    x = logits.astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    lse = np.log(np.exp(x).sum(-1))
    pick = np.take_along_axis(x, labels[..., None].astype(np.int64), -1)
    return float((lse - pick[..., 0]).mean())


def jax_run(shape, zero_stage, cfg_kw, np_params, np_batch):
    """JAX on the mesh: forward's logits at the initial params and the
    mean cross entropy on them (``loss_fn``'s value, its labels laid out
    as the logits under zigzag), then ``make_train_step``'s losses and
    final params."""
    cfg = _jcfg(**cfg_kw)
    hm = init_hybrid_mesh(**shape, set_global=False)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    with hm.mesh:
        p = JL.shard_params(jax.tree_util.tree_map(jnp.asarray, np_params),
                            cfg, hm.mesh)
        logits = np.asarray(jax.jit(lambda p, t: JL.forward(
            p, t, cfg, hm.mesh))(p, batch["tokens"]))
        labels = np_batch["labels"]
        if cfg.context_parallel == "zigzag":
            labels = labels[:, CP.zigzag_global_perm(T, shape["cp"])]
        loss = _nll(logits, labels)
        step, init = JL.make_train_step(cfg, hm.mesh, zero_stage=zero_stage)
        state = init(jax.random.PRNGKey(0))
        losses = []
        for _ in range(STEPS):
            state, value = step(state, batch)
            losses.append(float(value))
        return {"logits": logits, "loss_fn": loss, "losses": losses,
                "params": jax.tree_util.tree_map(np.asarray,
                                                 state["params"])}


@pytest.fixture(scope="module")
def runs():
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(cfg, jax.random.PRNGKey(0)))
    hm = init_hybrid_mesh(set_global=False)
    with hm.mesh:
        b = JL.make_batch(cfg, B, T, hm.mesh, key=jax.random.PRNGKey(1))
    np_batch = {k: np.asarray(v) for k, v in b.items()}
    spec = [(name, dict(shape, **({"ranks": RANKS[name]}
                                  if name in RANKS else {})), stage, kw)
            for name, shape, stage, kw in CASES]
    ctx = dist.spawn(ranks.train_cases, (np_params, np_batch, spec, STEPS),
                     nprocs=4, join=False)
    try:
        want = {name: jax_run(shape, stage, kw, np_params, np_batch)
                for name, shape, stage, kw in JAX_CASES}
    finally:
        world = ctx.join(timeout_s=300)
    return world, want, np_batch


def _recs(world, name):
    return [w["cases"][name] for w in world if name in w["cases"]]


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("name", [c[0] for c in JAX_CASES])
def test_three_steps_match_jax_on_the_same_mesh(runs, name):
    world, want, _ = runs
    w = want[name]
    got = next(w_["cases"][name] for w_ in world if name in w_["cases"]
               and "params" in w_["cases"][name])
    assert got["losses"][2] < got["losses"][0]
    np.testing.assert_allclose(got["losses"], w["losses"], rtol=1e-5,
                               atol=1e-5)
    for path, x in _leaves(w["params"]):
        np.testing.assert_allclose(_get(got["params"], path), x,
                                   err_msg=f"{name} {path}", rtol=1e-5,
                                   atol=3e-5)


@pytest.mark.parametrize("name", [c[0] for c in JAX_CASES])
def test_forward_and_loss_fn_match_jax(runs, name):
    """``forward``'s logits (gathered over cp and tp, in the layout's
    order: zigzag's permuted) and ``loss_fn`` (the mean of a rank's rows
    and cp part, averaged over the mesh) at the initial params."""
    world, want, _ = runs
    recs = _recs(world, name)
    dp = 1 + max(r["coords"]["dp"] for r in recs)
    rows = {r["coords"]["dp"]: r["logits"] for r in recs}
    np.testing.assert_allclose(
        np.concatenate([rows[i] for i in range(dp)], 0),
        want[name]["logits"], rtol=1e-5, atol=1e-5)
    mean = np.mean([r["loss_fn"] for r in recs])
    np.testing.assert_allclose(mean, want[name]["loss_fn"], rtol=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_every_rank_returns_the_global_mean_loss(runs, name):
    """The loss is the global mean, the same on every rank; each rank
    sits where JAX's device sits on the (dp, cp, tp) grid."""
    world, _, _ = runs
    recs = _recs(world, name)
    shape = dict(next(c[1] for c in CASES if c[0] == name))
    n = int(np.prod(list(shape.values())))
    assert len(recs) == n
    for r in recs[1:]:
        assert r["losses"] == recs[0]["losses"]
    axes = ("dp", "pp", "cp", "tp")
    grid = np.asarray(RANKS.get(name, range(n))).reshape(
        [shape.get(a, 1) for a in axes])
    for w in world:
        if name in w["cases"]:
            coords = w["cases"][name]["coords"]
            assert grid[tuple(coords.get(a, 0) for a in axes)] == w["rank"]


def test_zigzag_loss_equals_contiguous_loss(runs):
    """Every case starts from the same params and batch: the first
    step's loss (the global mean before the update) is the same under
    the contiguous ring, zigzag, Ulysses and the unfused zigzag."""
    world, _, _ = runs
    first = {c[0]: _recs(world, c[0])[0]["losses"][0] for c in CASES}
    ring = first["cp2_tp2_ring"]
    for name, x in first.items():
        np.testing.assert_allclose(x, ring, rtol=1e-5, err_msg=name)


def test_fused_rope_takes_the_zigzag_positions(runs):
    """Under zigzag the fused rope runs on each rank's cells at their
    global positions (JAX ``test_rope_sharded_seq_split_zigzag_
    positions``): every call of the first step (forward and remat
    recompute of each layer) on rank (dp d, cp c) gets
    ``chunk_positions(c, 2, T/2, "zigzag")`` for each of its rows; the
    unfused case calls none."""
    world, _, _ = runs
    L = 4
    for r in _recs(world, "dp2_cp2_zigzag"):
        want = CP.chunk_positions(r["coords"]["cp"], 2, T // 2, "zigzag")
        assert len(r["positions"]) == 2 * L
        for p in r["positions"]:
            assert p.shape == (B // 2, T // 2)
            assert (p == want[None].astype(p.dtype)).all()
    for r in _recs(world, "cp2_zigzag_unfused"):
        assert r["positions"] == []


def test_ring_p2p_bytes(runs):
    """cp 2 x tp 2 ring per step a rank: each layer's ring sends k and v
    (Hkv/tp heads, T/cp rows) once in the forward and once in the remat
    recompute; its backward sends them once more with the f32 dk / dv
    accumulators, which then go home once."""
    world, _, _ = runs
    L, Dh, Hkv_l = 4, 16, 1
    chunk = (B * (T // 2) * Hkv_l * Dh) * 4
    acc = chunk                                  # f32 accumulators
    per_layer = 2 * 2 * chunk + 2 * (chunk + acc) + 2 * acc
    for r in _recs(world, "cp2_tp2_ring"):
        assert r["stats"]["send"]["bytes"] == STEPS * L * per_layer


def test_fleet_sep_degree_trains(runs):
    """``fleet.init`` with sep_degree 2 and dp_degree 2 builds dp 2 x
    cp 2, and the zigzag step there trains: the dp2 x cp2 zigzag case's
    losses, bitwise."""
    world, _, _ = runs
    want = _recs(world, "dp2_cp2_zigzag")[0]["losses"]
    for w in world:
        assert w["fleet"]["degrees"] == (2, 2, 1)
        assert w["fleet"]["losses"] == want


def test_refusals(runs):
    """cp with a pipeline and any ep raise NotImplementedError; a cp
    axis with no context_parallel raises ValueError, as does Ulysses at
    a cp that does not divide the heads."""
    world, _, _ = runs
    w = world[0]
    assert w["pp"].startswith("NotImplementedError: context_parallel with "
                              "pp_stages > 1")
    assert w["ep"].startswith("NotImplementedError: expert (ep)")
    assert w["none"].startswith("ValueError: a cp=2 axis splits")
    assert w["ulysses_heads"].startswith("ValueError: ulysses needs cp "
                                         "degree 4")
