"""The port's collective API, hybrid mesh, ZeRO layout rule, Megatron
autograd pairs and vocab-parallel cross entropy.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; the rank
body ``collectives`` in ``tests/_torch_dist_ranks.py`` imports torch,
numpy and the port only) runs every collective; the tests hold its
results to numpy, the mesh's rank grid to JAX ``init_hybrid_mesh``'s
device grid, ``zero_spec`` to the JAX one, the f / g and sequence pairs'
gradients to dense autograd (f64, 1e-12), and the vocab-parallel cross
entropy and its gradient to JAX ``fused_softmax_cross_entropy`` on the
whole logits (f32, rtol 1e-6 / atol 1e-7)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import _torch_dist_ranks as ranks
from paddle_tpu.distributed.sharding import zero_spec as jax_zero_spec
from paddle_tpu.ops.fused import fused_softmax_cross_entropy
from paddle_tpu.parallel import init_hybrid_mesh as jax_mesh
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.sharding import zero_spec
from paddle_tpu_torch.parallel import P

N = 4
MESHES = [(2, 1, 2), (4, 1, 1), (1, 1, 4), (2, 2, 1)]


def _inputs():
    rng = np.random.default_rng(0)
    ce = {"logits": rng.standard_normal((2, 5, 16)).astype(np.float32) * 3,
          "labels": rng.integers(0, 16, (2, 5)).astype(np.int64),
          "g": rng.standard_normal((2, 5)).astype(np.float32)}
    grads = {"x": rng.standard_normal((2, 4, 6)),
             "w1": rng.standard_normal((6, 8)) * 0.5,
             "w2": rng.standard_normal((8, 6)) * 0.5,
             "c": rng.standard_normal((2, 4, 6))}
    return ce, grads


@pytest.fixture(scope="module")
def world():
    ce, grads = _inputs()
    return dist.spawn(ranks.collectives, (MESHES, ce, grads), nprocs=N,
                      timeout_s=300)


def _v(r):
    return np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1) + r


VALS = np.stack([_v(r) for r in range(N)])


def test_ranks_import_neither_jax_nor_the_jax_package(world):
    for w in world:
        assert w["in_sys_modules"] == [], w["in_sys_modules"]
        assert w["backend"] == "gloo"


@pytest.mark.parametrize("op,fn", [("sum", np.sum), ("max", np.max),
                                   ("min", np.min), ("prod", np.prod),
                                   ("avg", np.mean)])
def test_all_reduce(world, op, fn):
    for w in world:
        np.testing.assert_allclose(w[f"all_reduce_{op}"], fn(VALS, 0),
                                   rtol=1e-6)


def test_all_gather_broadcast_reduce_scatter_gather(world):
    for r, w in enumerate(world):
        np.testing.assert_array_equal(w["all_gather"], VALS)
        assert w["all_gather_object"] == [{"rank": i} for i in range(N)]
        np.testing.assert_array_equal(w["broadcast"], _v(2))
        if r == 1:
            np.testing.assert_array_equal(w["reduce"], VALS.sum(0))
        np.testing.assert_array_equal(w["scatter"], _v(r) * 10)
        if r == 3:
            np.testing.assert_array_equal(w["gather"], VALS)
        else:
            assert w["gather"] == []


def test_alltoall_and_reduce_scatter(world):
    for r, w in enumerate(world):
        want = np.stack([_v(j) + 100 * r for j in range(N)])
        np.testing.assert_array_equal(w["alltoall"], want)
        src = np.stack([np.arange(8, dtype=np.float32) + 10 * j
                        for j in range(N)])
        np.testing.assert_array_equal(
            w["alltoall_single"], src[:, 2 * r:2 * r + 2].reshape(-1))
        np.testing.assert_array_equal(w["reduce_scatter"],
                                      VALS.sum(0) + N * r)


def test_p2p_subgroup_and_objects(world):
    for r, w in enumerate(world):
        np.testing.assert_array_equal(w["ring"], _v((r - 1) % N))
        t, sub_rank, sub_n = w["subgroup"]
        want = VALS[[1, 3]].sum(0) if r in (1, 3) else _v(r)
        np.testing.assert_array_equal(t, want)
        assert (sub_rank, sub_n) == ({1: 0, 3: 1}.get(r, -1), 2)
        assert w["broadcast_object_list"] == [{"from": 1, "x": [1]}]
        assert w["scatter_object_list"] == [2 * r, 2 * r + 1]


def test_collective_counters(world):
    """Calls and bytes by kind: an all-reduce counts its tensor, an
    all-gather its gathered output, a reduce-scatter its full input."""
    s = world[0]["stats"]
    assert s["all_reduce"] == {"calls": 5 + 0, "bytes": 5 * 24,
                               "seconds": s["all_reduce"]["seconds"]}
    assert s["all_gather"]["calls"] == 1
    assert s["all_gather"]["bytes"] == N * 24
    assert s["gather"]["bytes"] == N * 24
    assert s["reduce_scatter"] == {"calls": 1, "bytes": N * 24,
                                   "seconds": s["reduce_scatter"]["seconds"]}
    assert s["alltoall"]["bytes"] == 2 * N * 24
    assert s["broadcast"]["calls"] == 1 and s["reduce"]["calls"] == 1
    assert s["barrier"]["calls"] == 1


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_grid_matches_jax_devices(world, shape):
    """Rank r sits where device r sits in JAX's mesh; each axis's groups
    are the lines of the grid along it; the degrees match."""
    dp, pp, tp = shape
    jm = jax_mesh(dp=dp, pp=pp, tp=tp, set_global=False)
    ids = np.vectorize(lambda d: d.id)(jm.mesh.devices)
    names = list(jm.mesh.axis_names)
    for r, w in enumerate(world):
        g = w["grids"][shape]
        np.testing.assert_array_equal(g["grid"], ids)
        assert g["degrees"] == (jm.dp_degree, jm.pp_degree, jm.tp_degree,
                                jm.world_size)
        at = tuple(int(c) for c in np.argwhere(ids == r)[0])
        assert g["coords"] == at
        for a, line in g["lines"].items():
            i = names.index(a)
            idx = list(at)
            idx[i] = slice(None)
            assert line == [int(x) for x in ids[tuple(idx)]], (a, r)


def test_functional_collectives_over_mesh_axes(world):
    grid = np.arange(N).reshape(2, 2)            # (dp, tp)
    for r, w in enumerate(world):
        f = w["functional"]
        d, t = (int(c) for c in np.argwhere(grid == r)[0])
        tp_line, dp_line = grid[d], grid[:, t]
        np.testing.assert_array_equal(f["all_reduce_tp"],
                                      VALS[tp_line].sum(0))
        np.testing.assert_array_equal(f["all_reduce_dp_max"],
                                      VALS[dp_line].max(0))
        np.testing.assert_array_equal(f["all_gather_tp"],
                                      np.concatenate(VALS[tp_line], 1))
        np.testing.assert_array_equal(f["all_gather_tp_stacked"],
                                      VALS[tp_line])
        full = sum(np.arange(4.0) * (q + 1) for q in dp_line)
        np.testing.assert_array_equal(f["reduce_scatter_dp"],
                                      full[2 * d:2 * d + 2])
        src = [np.arange(4.0).reshape(2, 2) + 10 * q for q in tp_line]
        np.testing.assert_array_equal(
            f["all_to_all_tp"], np.concatenate([s[t:t + 1] for s in src], 1))
        np.testing.assert_array_equal(
            f["ppermute_dp"], VALS[dp_line[0]] if d == 1 else 0 * VALS[0])
        np.testing.assert_array_equal(f["send_recv_next_tp"],
                                      VALS[tp_line[1 - t]])
        assert f["axis_index"] == (d, t)
        np.testing.assert_array_equal(f["pp_identity"], VALS[r])


ZERO_CASES = [
    ((None, "tp"), (32, 64), 8), (("tp",), (32, 64), 8), ((), (7, 9), 8),
    ((), (), 8), (("dp", None), (32, 64), 8), ((None, None), (6, 8), 4),
    ((None, None, "tp"), (4, 64, 64), 2), (("tp", None), (256, 64), 2),
    ((None, ("dp", "tp")), (8, 8), 2), ((None,), (3,), 2),
    ((None, None), (0, 8), 2)]


@pytest.mark.parametrize("spec,shape,dp", ZERO_CASES)
def test_zero_spec_matches_jax(spec, shape, dp):
    want = jax_zero_spec(JP(*spec), shape, dp)
    got = zero_spec(P(*spec), shape, dp)
    assert (got is None) == (want is None)
    if want is not None:
        assert tuple(got) == tuple(want)


@pytest.mark.parametrize("pair", ["fg", "seq"])
def test_megatron_pairs_gradients_match_dense(world, pair):
    """At tp 2 (ranks 0, 1 of the (dp 2, tp 2) mesh): the f / g pair
    gives every rank the dense output and input gradient and its columns
    / rows of the weight gradients; the sequence pair the same on its
    sequence rows."""
    for r in (0, 1):
        g, dense = world[r]["grads"][pair], world[r]["grads"]["dense"]
        F_, T = 4, 2
        if pair == "fg":
            want_y, want_dx = dense["y"], dense["dx"]
        else:
            want_y = dense["y"][:, r * T:(r + 1) * T]
            want_dx = dense["dx"][:, r * T:(r + 1) * T]
        tol = dict(rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g["y"], want_y, **tol)
        np.testing.assert_allclose(g["dx"], want_dx, **tol)
        np.testing.assert_allclose(g["dw1"],
                                   dense["dw1"][:, r * F_:(r + 1) * F_],
                                   **tol)
        np.testing.assert_allclose(g["dw2"], dense["dw2"][r * F_:(r + 1) * F_],
                                   **tol)


def test_vocab_parallel_cross_entropy_matches_jax(world):
    ce, _ = _inputs()
    logits = jnp.asarray(ce["logits"])
    labels = jnp.asarray(ce["labels"])
    want = fused_softmax_cross_entropy(logits, labels)
    grad = jax.grad(lambda z: (fused_softmax_cross_entropy(z, labels)
                               * ce["g"]).sum())(logits)
    got = [world[r]["ce"] for r in (0, 1)]
    for g in got:
        np.testing.assert_allclose(g["nll"], np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        np.concatenate([g["grad"] for g in got], -1), np.asarray(grad),
        rtol=1e-6, atol=1e-7)


def test_sharded_norm_and_rope_refuse_a_sharded_last_dim():
    """As the JAX entries (fused_norm_rope.py:315-318, :369-372): the
    norm reduces over, and rope rotates within, the last dim."""
    import torch
    from paddle_tpu_torch.ops.kernels.fused_norm_rope import (
        fused_rms_norm_sharded, fused_rope_sharded)
    x, w = torch.ones(2, 4, 8), torch.ones(8)
    with pytest.raises(ValueError, match="shards it"):
        fused_rms_norm_sharded(x, w, P(None, None, "tp"))
    q = torch.ones(1, 4, 2, 16)
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="unsharded"):
        fused_rope_sharded(q, q, pos, P(None, None, "tp", "tp"),
                           P(None, None, "tp", None))
