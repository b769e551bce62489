"""The port's Paddle-API wrappers over ``torch.distributed``: the
``mpu`` layers and the sequence-parallel linears against dense math,
``DataParallel`` against the JAX package's ``DataParallel``,
``fleet.init``'s degrees, and ``group_sharded_parallel`` at ``os`` /
``os_g`` / ``p_g_os`` against an unsharded step.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; the rank
body ``fleet_api`` in ``tests/_torch_dist_ranks.py``). Contract (f32):
rtol / atol 1e-5 against dense and JAX, 1e-6 between a sharded and an
unsharded AdamW step (the same arithmetic, the mean taken over two
halves)."""
import numpy as np
import pytest

import paddle_tpu as pt
import _torch_dist_ranks as ranks
from paddle_tpu import distributed as jdist
from paddle_tpu_torch import distributed as dist

LEVELS = ["os", "os_g", "p_g_os"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mpu = {"w1": f(16, 32) * 0.3, "b1": f(32), "w2": f(32, 16) * 0.3,
           "b2": f(16), "x": f(4, 16), "c": f(4, 16), "table": f(64, 8),
           "tokens": np.array([[1, 2], [3, 63], [17, 40]]),
           "ce": f(3, 2, 8), "logits": f(3, 20) * 2,
           "labels": np.array([4, 19, -100]), "xs": f(2, 8, 16),
           "cs": f(2, 8, 16), "nw": 1.0 + 0.1 * f(16)}
    dp = {"l1_w": f(4, 6) * 0.5, "l1_b": f(6) * 0.1, "l2_w": f(6, 3) * 0.5,
          "l2_b": f(3) * 0.1, "x": f(8, 4), "y": f(8, 3)}
    return mpu, dp


@pytest.fixture(scope="module")
def world():
    mpu, dp = _inputs()
    return dist.spawn(ranks.fleet_api, (mpu, dp, LEVELS), nprocs=4,
                      timeout_s=300)


def _dense_mlp(inp):
    x, w1, b1, w2, b2, c = (inp[k].astype(np.float64) for k in
                            ("x", "w1", "b1", "w2", "b2", "c"))
    y = (x @ w1 + b1) @ w2 + b2
    # y = h @ w2 + b2, h = x @ w1 + b1, loss = sum(y * c)
    dh = c @ w2.T
    return {"y": y, "dx": dh @ w1.T, "dw1": x.T @ dh, "db1": dh.sum(0),
            "dw2": (x @ w1 + b1).T @ c, "db2": c.sum(0)}


def test_column_row_parallel_match_dense(world):
    inp = _inputs()[0]
    d = _dense_mlp(inp)
    for r, w in enumerate(world):
        m = w["mpu"]
        cols = slice(r * 8, (r + 1) * 8)
        np.testing.assert_allclose(m["y"], d["y"], **TOL)
        np.testing.assert_allclose(m["gathered"], d["y"], **TOL)
        np.testing.assert_allclose(m["dx"], d["dx"], **TOL)
        np.testing.assert_allclose(m["dw1"], d["dw1"][:, cols], **TOL)
        np.testing.assert_allclose(m["db1"], d["db1"][cols], **TOL)
        np.testing.assert_allclose(m["dw2"], d["dw2"][cols], **TOL)
        np.testing.assert_allclose(m["db2"], d["db2"], **TOL)
        np.testing.assert_array_equal(m["split"], inp["x"][:, r * 4:r * 4 + 4])
        assert m["bad_width"].startswith(
            "ValueError: out_features 30 not divisible by tp degree 4")


def test_vocab_parallel_embedding_and_cross_entropy(world):
    inp = _inputs()[0]
    tok, table, ce = inp["tokens"], inp["table"], inp["ce"]
    logits, labels = inp["logits"].astype(np.float64), inp["labels"]
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + \
        logits.max(1)
    keep = labels != -100
    nll = np.where(keep, lse - logits[np.arange(3), np.maximum(labels, 0)],
                   0.0)
    p = np.exp(logits - lse[:, None])
    p[np.arange(3), np.maximum(labels, 0)] -= 1
    dlogits = p * keep[:, None]
    demb = np.zeros_like(table)
    np.add.at(demb, tok, ce)
    for r, w in enumerate(world):
        m = w["mpu"]
        np.testing.assert_array_equal(m["emb"], table[tok])
        np.testing.assert_allclose(m["demb"], demb[r * 16:(r + 1) * 16],
                                   **TOL)
        np.testing.assert_allclose(m["nll"], nll, **TOL)
        np.testing.assert_allclose(m["dlogits"],
                                   dlogits[:, r * 5:(r + 1) * 5], **TOL)


def test_sequence_parallel_linears_and_norm_hooks(world):
    """Each rank's 2 of 8 rows through ColumnSequenceParallelLinear ->
    RowSequenceParallelLinear equal the dense rows; a weight marked
    ``sequence_parallel`` gets the whole gradient after its hook."""
    inp = _inputs()[0]
    xs, cs, nw = (inp[k].astype(np.float64) for k in ("xs", "cs", "nw"))
    w1, b1, w2, b2 = (inp[k].astype(np.float64) for k in
                      ("w1", "b1", "w2", "b2"))
    xn = xs * nw
    y = (xn @ w1 + b1) @ w2 + b2
    dh = cs @ w2.T
    dxn = dh @ w1.T
    for r, w in enumerate(world):
        s, rows = w["mpu"]["seq"], slice(r * 2, (r + 1) * 2)
        np.testing.assert_allclose(s["y"], y[:, rows], **TOL)
        np.testing.assert_allclose(s["dx"], (dxn * nw)[:, rows], **TOL)
        np.testing.assert_allclose(s["dnw"], (dxn * xs).sum((0, 1)), **TOL)
        np.testing.assert_allclose(
            s["dw1"], np.einsum("btd,btf->df", xn, dh)[:, r * 8:r * 8 + 8],
            **TOL)
        assert s["hooks"] == 1
        np.testing.assert_array_equal(w["mpu"]["marked"],
                                      inp["xs"][:, rows])


def _jax_dp_grads(inp, rows):
    """JAX ``DataParallel`` over the same two layers: the gradients of
    the mean over ``rows``."""
    m = pt.nn.Sequential(pt.nn.Linear(4, 6), pt.nn.ReLU(),
                         pt.nn.Linear(6, 3))
    m[0].weight.set_value(inp["l1_w"])
    m[0].bias.set_value(inp["l1_b"])
    m[2].weight.set_value(inp["l2_w"])
    m[2].bias.set_value(inp["l2_b"])
    model = jdist.DataParallel(m)
    x, y = pt.to_tensor(inp["x"][rows]), pt.to_tensor(inp["y"][rows])
    loss = ((model(x) - y) ** 2).mean()
    loss.backward()
    return [m[0].weight.grad.numpy(), m[0].bias.grad.numpy(),
            m[2].weight.grad.numpy(), m[2].bias.grad.numpy()]


def test_data_parallel_grads_equal_jax_whole_batch(world):
    """Two ranks with half the rows each: after backward every rank
    holds the gradient of the whole batch's mean, as the JAX
    ``DataParallel`` computes it on the whole batch; under ``no_sync``
    each keeps its own half's until ``apply_collective_grads``."""
    inp = _inputs()[1]
    want = _jax_dp_grads(inp, slice(0, 8))
    names = ["0.weight", "0.bias", "2.weight", "2.bias"]
    for r in (0, 1):
        d = world[r]["dp"]
        for n, w in zip(names, want):
            np.testing.assert_allclose(d["synced"][n], w, **TOL)
            np.testing.assert_allclose(d["applied"][n], w, **TOL)
        half = _jax_dp_grads(inp, slice(r * 4, (r + 1) * 4))
        for n, w in zip(names, half):
            np.testing.assert_allclose(d["local"][n], w, **TOL)
    assert world[2]["dp"] is None


def test_fleet_init_degrees(world):
    for r, w in enumerate(world):
        f = w["fleet_tp"]
        assert f["degrees"] == (2, 1, 2)
        assert f["hcg_is_mesh"] and f["model_kept"]
        assert f["workers"] == (4, r, r == 0)
        assert w["fleet_dp"] == {"degrees": (4, 1, 1),
                                 "wrapped": "DataParallel"}


@pytest.mark.parametrize("level", LEVELS)
def test_group_sharded_parallel_matches_unsharded_step(world, level):
    """Three AdamW steps on half the rows each equal the unsharded step
    on all of them; the moments are halved on each rank, and at
    ``p_g_os`` the parameters hold no whole storage between steps. The
    3-wide bias has no dim 2 divides: it stays whole (with a warning)."""
    for r in (0, 1):
        s = world[r]["sharded"][level]
        for got, want in zip(s["params"], s["ref"]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        sizes = [w.size for w in s["ref"]]
        owned = [n // 2 if n % 2 == 0 else n for n in sizes]
        assert sorted(s["moment_numel"]) == sorted(owned)
        assert s["at_rest"] == ([0, 0, 0, 3] if level == "p_g_os"
                                else sizes)
    assert world[3]["sharded"][level] is None
