"""The port's expert-parallel MoE vs the JAX package: ``moe_ffn`` with
``ep_axis="ep"`` at ep 4 and dp 2 x ep 2, at capacity_factor 0.5 (tokens
dropped) and 2.0 (none dropped), against JAX's ``moe_ffn(ep_axis="ep")``
on the conftest's 8-device mesh and against the unsharded one;
``top_k_gating`` of a dp rank's rows (the global batch's queues, under
the default and the random policy); ``MoELayer`` with each gate (GShard
with a key, Switch with jitter) at one device and at ep 2 (GShard also at
dp 2 x ep 2); the refusals.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; rank bodies
in ``tests/_torch_ep_ranks.py``). Inputs from numpy with a seed, the
layer's parameters from the JAX layer's. Each rank's loss is
``dp · <y, ct> + aux`` on its dp rows (the mesh trainer's convention:
its rows' share of the mean plus the global aux term), so the mean of
its dp peers' gradients is JAX's gradient of ``<y, ct> + aux``.
Contract (f32): y, aux and the gradients of x, the router and the
experts within rtol = atol 1e-5; the dispatch tensors (which (token,
slot) pairs are kept, at which queue position) equal JAX's exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_ep_ranks as ranks
import _torch_threads  # noqa: F401
from paddle_tpu.incubate.moe import MoELayer as JMoELayer
from paddle_tpu.incubate.moe import functional as JF
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import prng
from paddle_tpu_torch.incubate import moe as TM
from paddle_tpu_torch.incubate.moe import functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)
S, D, F, E, K = 32, 16, 24, 4, 2
CFS = (0.5, 2.0)
MESHES = {"ep4": dict(ep=4), "dp2_ep2": dict(dp=2, ep=2)}
CASES = [(f"{m}_cf{cf}", shape, cf) for m, shape in MESHES.items()
         for cf in CFS]
# MoELayer: (name, mesh, gate type, key seed)
LB, LT = 4, 8
GATES = [("naive", None), ("gshard", 11), ("switch", 12)]
LAYER_CASES = [(f"ep2_{g}", dict(ep=2, ranks=(0, 1)), g, s)
               for g, s in GATES] + [
    ("dp2_ep2_gshard", dict(dp=2, ep=2), "gshard", 13)]


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(S, D).astype(np.float32)
    gate_w = rs.randn(D, E).astype(np.float32)
    ws = [(rs.randn(*shape) * 0.1).astype(np.float32)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    ct = rs.randn(S, D).astype(np.float32)
    logits = rs.randn(S, E).astype(np.float32)
    return (x, gate_w, *ws, ct, logits)


def _jax_moe(inputs, cf, shape=None):
    """JAX ``moe_ffn`` y, aux and the gradients of ``<y, ct> + aux`` w.r.t.
    x, the router and the experts; with ``shape`` on that mesh
    (``ep_axis="ep"``, x over dp, the experts over ep)."""
    x, gate_w, wg, wu, wd, ct, _ = map(jnp.asarray, inputs)

    def f(x, gate_w, wg, wu, wd):
        y, aux = JF.moe_ffn(x, gate_w, wg, wu, wd, top_k=K,
                            capacity_factor=cf,
                            ep_axis=None if shape is None else "ep")
        return jnp.vdot(y, ct) + aux, (y, aux)

    fn = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4), has_aux=True)
    args = (x, gate_w, wg, wu, wd)
    if shape is None:
        (_, (y, aux)), grads = fn(*args)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        hm = init_hybrid_mesh(**shape, set_global=False)
        with hm.mesh:
            put = lambda a, *sp: jax.device_put(a, NamedSharding(hm.mesh,
                                                                 P(*sp)))
            args = (put(x, "dp", None), gate_w,
                    *(put(w, "ep", None, None) for w in (wg, wu, wd)))
            (_, (y, aux)), grads = jax.jit(fn)(*args)
    return (np.asarray(y), float(aux), [np.asarray(g) for g in grads])


class _JaxLayer:
    """The JAX ``MoELayer`` and the gradients of ``<y, ct> + l_aux``
    w.r.t. x and its parameters (each parameter's data swapped for the
    traced value while the layer runs)."""

    def __init__(self, kind):
        self.layer = JMoELayer(D, num_expert=E, d_hidden=F,
                               gate={"type": kind, "top_k": K})
        self.named = list(self.layer.named_parameters())
        self.state = {n: np.asarray(p.data) for n, p in self.named}

    def run(self, x, ct, seed):
        key = None if seed is None else jax.random.PRNGKey(seed)
        datas = [p.data for _, p in self.named]

        def f(x, ws):
            for (_, p), w in zip(self.named, ws):
                p.data = w
            y = self.layer(x, key=key)
            y = y.data if hasattr(y, "data") else y
            return jnp.vdot(y, jnp.asarray(ct)) + self.layer.l_aux, (
                y, self.layer.l_aux)

        try:
            (_, (y, aux)), (dx, dws) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), datas)
        finally:
            for (_, p), w in zip(self.named, datas):
                p.data = w
        return {"y": np.asarray(y), "aux": float(aux), "dx": np.asarray(dx),
                "grads": {n: np.asarray(g)
                          for (n, _), g in zip(self.named, dws)}}


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    rs = np.random.RandomState(1)
    lx = rs.randn(LB, LT, D).astype(np.float32)
    lct = rs.randn(LB, LT, D).astype(np.float32)
    layers = {kind: _JaxLayer(kind) for kind, _ in GATES}
    states = {kind: layer.state for kind, layer in layers.items()}
    ctx = dist.spawn(ranks.functional_cases,
                     (inputs, CASES, (states, lx, lct), LAYER_CASES),
                     nprocs=4, join=False)
    try:
        want = {cf: _jax_moe(inputs, cf) for cf in CFS}
        want_mesh = {c[0]: _jax_moe(inputs, c[2], c[1]) for c in CASES}
        want_layer = {c[0]: layers[c[2]].run(lx, lct, c[3])
                      for c in LAYER_CASES}
    finally:
        world = ctx.join(timeout_s=300)
    return dict(inputs=inputs, world=world, want=want, want_mesh=want_mesh,
                layers=layers, want_layer=want_layer, lx=lx, lct=lct)


def _dp_mean(recs, pick):
    """The mean over dp peers of ``pick(rec)`` (one ep index)."""
    ep0 = [r for r in recs if r["coords"][1] == 0]
    return sum(pick(r) for r in ep0) / len(ep0)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_moe_ffn_ep_matches_jax(runs, name):
    """y rows, aux and the gradients on every rank against JAX's
    unsharded ``moe_ffn`` and its ``ep_axis`` run on the same mesh."""
    shape, cf = next((s, c) for n, s, c in CASES if n == name)
    recs = [w["cases"][name] for w in runs["world"]
            if name in w["cases"]]
    dp, ep = shape.get("dp", 1), shape["ep"]
    assert len(recs) == dp * ep
    n, El = S // dp, E // ep
    for want in (runs["want"][cf], runs["want_mesh"][name]):
        y, aux, (gx, gr, *gws) = want
        for r in recs:
            i, j = r["coords"]
            np.testing.assert_allclose(r["y"], y[i * n:(i + 1) * n], **TOL)
            np.testing.assert_allclose(r["aux"], aux, **TOL)
            np.testing.assert_allclose(r["grads"][0] / dp,
                                       gx[i * n:(i + 1) * n], **TOL)
        np.testing.assert_allclose(
            _dp_mean(recs, lambda r: r["grads"][1]), gr, **TOL)
        for j in range(ep):
            mine = [r for r in recs if r["coords"][1] == j]
            for w_i, gw in enumerate(gws):
                got = sum(r["grads"][2 + w_i] for r in mine) / dp
                np.testing.assert_allclose(got, gw[j * El:(j + 1) * El],
                                           **TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_replicated_gradients_equal_across_ep(runs, name):
    """ep peers hold the same tokens: their y, aux and the gradients of
    the replicated x and router are bitwise equal."""
    recs = [w["cases"][name] for w in runs["world"]
            if name in w["cases"]]
    for r in recs:
        peer = next(p for p in recs if p["coords"][0] == r["coords"][0])
        assert np.array_equal(r["y"], peer["y"]) and r["aux"] == peer["aux"]
        for a, b in zip(r["grads"][:2], peer["grads"][:2]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("policy", ["all", "random"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_gating_rows_are_the_global_batchs(runs, name, policy):
    """``top_k_gating`` of a dp rank's rows with ``dp_axis``: dispatch
    equal to the rows of JAX's global dispatch exactly (the dropped set
    and every queue position), combine and aux within 1e-5; the random
    policy draws the global batch's uniforms."""
    shape, cf = next((s, c) for n, s, c in CASES if n == name)
    logits = runs["inputs"][-1]
    cap = JF.default_capacity(S, E, K, cf)
    key = jax.random.PRNGKey(7) if policy == "random" else None
    d, c, aux = JF.top_k_gating(jnp.asarray(logits), K, cap, key=key,
                                second_policy=policy)
    d, c = np.asarray(d), np.asarray(c)
    n = S // shape.get("dp", 1)
    for w in runs["world"]:
        if name not in w["cases"]:
            continue
        r = w["cases"][name]
        i = r["coords"][0]
        gd, gc, ga = r["gating"][policy]
        assert np.array_equal(gd, d[i * n:(i + 1) * n])
        np.testing.assert_allclose(gc, c[i * n:(i + 1) * n], **TOL)
        np.testing.assert_allclose(ga, float(aux), **TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dropped_count_is_jaxs(runs, name):
    """``record_dropped``'s count in ``moe_ffn``: the (token, slot) pairs
    JAX's global gating drops, on every rank; none at capacity_factor
    2.0 = E / top_k."""
    _, cf = next((s, c) for n, s, c in CASES if n == name)
    x, gate_w = runs["inputs"][:2]
    cap = JF.default_capacity(S, E, K, cf)
    d, _, _ = JF.top_k_gating(jnp.asarray(x @ gate_w), K, cap)
    want = S * K - float(np.asarray(d).sum())
    assert (want > 0) == (cf < 2.0)
    for w in runs["world"]:
        if name in w["cases"]:
            assert w["cases"][name]["dropped"] == [want]


def _port_layer(runs, kind):
    layer = TM.MoELayer(D, num_expert=E, d_hidden=F, device="cpu",
                        gate={"type": kind, "top_k": K})
    layer.load_jax_state(runs["layers"][kind].state)
    return layer


@pytest.mark.parametrize("kind,seed", GATES)
def test_moe_layer_one_device_matches_jax(runs, kind, seed):
    """On one device: y, l_aux and the gradients of x and of every
    parameter of ``MoELayer`` with the gate (GShard's random second
    expert from the key, Switch's jitter from it)."""
    want = runs["layers"][kind].run(runs["lx"], runs["lct"], seed)
    layer = _port_layer(runs, kind)
    x = torch.from_numpy(runs["lx"]).requires_grad_()
    y = layer(x, key=None if seed is None else prng.key(seed))
    ((y * torch.from_numpy(runs["lct"])).sum() + layer.l_aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), want["y"], **TOL)
    np.testing.assert_allclose(float(layer.l_aux.detach()), want["aux"],
                               **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want["dx"], **TOL)
    for n, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want["grads"][n],
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("name", [c[0] for c in LAYER_CASES])
def test_moe_layer_ep_matches_jax(runs, name):
    """Under ep the layer runs its rank's experts; after backward every
    ep rank holds JAX's whole gradient (the gate's and every expert's,
    averaged over dp peers), and its rows of y, l_aux and x's
    gradient."""
    shape, kind = next((s, k) for n, s, k, _ in LAYER_CASES if n == name)
    want = runs["want_layer"][name]
    recs = [w["layer"][name] for w in runs["world"]
            if name in w["layer"]]
    dp = shape.get("dp", 1)
    assert len(recs) == dp * shape["ep"]
    n = LB // dp
    for r in recs:
        i, j = r["coords"]
        np.testing.assert_allclose(r["y"], want["y"][i * n:(i + 1) * n],
                                   **TOL)
        np.testing.assert_allclose(r["aux"], want["aux"], **TOL)
        np.testing.assert_allclose(r["dx"] / dp,
                                   want["dx"][i * n:(i + 1) * n], **TOL)
        peers = [p for p in recs if p["coords"][1] == j]
        for pn, g in want["grads"].items():
            got = sum(p["grads"][pn] for p in peers) / dp
            np.testing.assert_allclose(got, g, err_msg=pn, **TOL)


def test_refusals(runs):
    """``ep_axis`` with no global mesh whose ep > 1 raises ValueError
    (``moe_ffn`` and ``moe_expert_compute``), as does an expert count
    that ep does not divide."""
    x, gate_w, wg, wu, wd = (torch.from_numpy(a) for a in
                             runs["inputs"][:5])
    with pytest.raises(ValueError, match="ep_axis='ep'"):
        TF.moe_ffn(x, gate_w, wg, wu, wd, ep_axis="ep")
    d = torch.zeros(S, E, 4)
    with pytest.raises(ValueError, match="ep_axis='ep'"):
        TF.moe_expert_compute(x, d, d, wg, wu, wd, ep_axis="ep")
    assert runs["world"][0]["uneven"] == (
        "ValueError: 6 experts do not split over ep=4")
