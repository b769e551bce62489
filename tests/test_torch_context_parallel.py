"""The port's context-parallel attention vs the JAX package's
``context_parallel_attention`` on the same mesh: ring, zigzag and
Ulysses, causal and not, at cp 4 and at cp 2 x tp 2 with GQA.

One spawned gloo world of 4 CPU ranks (``distributed.spawn``; rank
bodies in ``tests/_torch_cp_ranks.py``) runs every case while the JAX
package computes its side here on the conftest's 8-device CPU mesh. Each
case runs the port's entry and, for the rings, ``ring_attention`` itself:
the card's ring algebra (merged (o, lse), dq / dkv per hop on the merged
statistics, the dk / dv accumulators travelling home) on the flash
kernels' plain counterparts.
Contract (f32): outputs within rtol / atol 1e-5, gradients within 1e-5
of their largest magnitude. The hop schedule, the positions, the
loopback ring and the raises are pinned without a world."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_cp_ranks as ranks
import _torch_threads  # noqa: F401
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jfa
from paddle_tpu.parallel import context_parallel as JCP
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.parallel import context_parallel as CP

B, T, D = 2, 32, 16
GEOM = {"cp4": dict(cp=4), "cp2_tp2": dict(cp=2, tp=2)}
# (name, mesh, fn, kind, causal); Ulysses runs on the entry only
CASES = (
    [(f"cp4_{fn}_{kind}_{'c' if c else 'n'}", "cp4", fn, kind, c)
     for kind in ("ring", "zigzag", "ulysses") for c in (True, False)
     for fn in ("entry", "flash") if not (fn == "flash"
                                          and kind == "ulysses")]
    + [(f"cp2_tp2_{fn}_{kind}", "cp2_tp2", fn, kind, True)
       for kind in ("ring", "zigzag", "ulysses")
       for fn in ("entry", "flash") if not (fn == "flash"
                                            and kind == "ulysses")])


def _inputs(seed):
    """Global f32 q [B, T, 8, D], k / v [B, T, 4, D] and the output
    cotangent."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, 8, D).astype(np.float32)
    k = rs.randn(B, T, 4, D).astype(np.float32)
    v = rs.randn(B, T, 4, D).astype(np.float32)
    do = rs.randn(B, T, 8, D).astype(np.float32)
    return q, k, v, do


def _laid_out(x, kind, mesh):
    if kind != "zigzag":
        return x
    return x[:, CP.zigzag_global_perm(T, GEOM[mesh]["cp"])]


def jax_case(inp, mesh, kind, causal):
    """JAX ``context_parallel_attention`` and its vjp on the mesh."""
    hm = init_hybrid_mesh(**GEOM[mesh], set_global=False)
    q, k, v, do = (jnp.asarray(x) for x in inp)

    def f(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: JCP.context_parallel_attention(
            q, k, v, hm.mesh, impl=kind, causal=causal), q, k, v)
        return o, vjp(do)

    with hm.mesh:
        o, g = jax.jit(f)(q, k, v, do)
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def runs():
    base = _inputs(0)
    inputs = {c[0]: [_laid_out(x, c[3], c[1]) for x in base]
              for c in CASES}
    spec = [(name, GEOM[mesh], fn, kind, causal)
            for name, mesh, fn, kind, causal in CASES]
    ctx = dist.spawn(ranks.attention_cases, (inputs, spec), nprocs=4,
                     join=False)
    try:
        want = {}
        for name, mesh, fn, kind, causal in CASES:
            key = (mesh, kind, causal)
            if key not in want:
                want[key] = jax_case(inputs[name], mesh, kind, causal)
    finally:
        world = ctx.join(timeout_s=300)
    return world, want


def _assemble(world, name, which):
    """The global array of every rank's part (o, or gradient ``which``)."""
    recs = [w["cases"][name] for w in world if name in w["cases"]]
    cp = 1 + max(r["coords"][0] for r in recs)
    tp = 1 + max(r["coords"][1] for r in recs)
    part = lambda r: r["o"] if which is None else r["grads"][which]
    grid = {r["coords"]: part(r) for r in recs}
    return np.concatenate([np.concatenate([grid[(i, j)] for j in range(tp)],
                                          2) for i in range(cp)], 1)


@pytest.mark.parametrize("name,mesh,fn,kind,causal", CASES)
def test_attention_matches_jax_on_the_same_mesh(runs, name, mesh, fn, kind,
                                                causal):
    world, want = runs
    wo, wg = want[(mesh, kind, causal)]
    np.testing.assert_allclose(_assemble(world, name, None), wo, rtol=1e-5,
                               atol=1e-5)
    for i, g in enumerate(wg):
        got = _assemble(world, name, i)
        err = np.abs(got - g).max()
        assert err <= 1e-5 * np.abs(g).max(), (name, "qkv"[i], err)


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[2] == "flash"])
def test_flash_ring_is_bitwise_run_to_run_and_matches_loopback(runs, name):
    """The kernel ring's gradients carry no atomics: two runs give the
    same bits, and the one-process loopback of the same schedule gives
    the distributed ring's bits."""
    world, _ = runs
    _, mesh, _, kind, causal = next(c for c in CASES if c[0] == name)
    recs = [w["cases"][name] for w in world if name in w["cases"]]
    assert all(r["bitwise"] for r in recs)
    if mesh != "cp4":
        return
    # the loopback takes the sequence in natural order and lays it out
    # itself
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(0))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # as the ranks run
    try:
        o = CP.ring_loopback(*leaves, 4, causal=causal,
                             layout="zigzag" if kind == "zigzag"
                             else "contiguous", impl="reference")
        grads = torch.autograd.grad(o, leaves, do)
    finally:
        torch.set_num_threads(threads)
    if kind == "zigzag":
        perm = CP.zigzag_global_perm(T, 4)
        o, grads = o[:, perm], [g[:, perm] for g in grads]
    assert np.array_equal(o.detach().numpy(), _assemble(world, name, None))
    for i, g in enumerate(grads):
        assert np.array_equal(g.numpy(), _assemble(world, name, i)), i


@pytest.mark.parametrize("kind", ["ring", "zigzag"])
def test_flash_ring_moves_the_unrepeated_kv_chunk(runs, kind):
    """The forward sends k and v (Hkv heads) R - 1 times; the backward
    sends them R - 1 times and the f32 dk / dv accumulators R times."""
    world, _ = runs
    rec = world[0]["cases"][f"cp4_flash_{kind}_c"]
    chunk = B * (T // 4) * 4 * D * 4          # one of k, v: f32, Hkv 4
    fwd, bwd = 3 * 2 * chunk, 3 * 2 * chunk + 4 * 2 * chunk
    assert rec["stats"]["send"]["bytes"] == fwd + bwd


def test_refusals(runs):
    world, _ = runs
    assert world[0]["ulysses_heads"].startswith(
        "ValueError: ulysses needs cp degree 4 to divide local head counts")
    assert world[0]["zigzag_odd"].startswith(
        "ValueError: zigzag needs an even per-rank chunk")


# ---------------------------------------------------------------------------
# without a world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,Tl", [(1, 8), (2, 8), (4, 6), (8, 4)])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_positions_equal_jax_bitwise(R, Tl, layout):
    for r in range(R):
        got = CP.chunk_positions(r, R, Tl, layout)
        want = np.asarray(JCP.chunk_positions(r, R, Tl, layout))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = CP.zigzag_global_perm(R * Tl, R), JCP.zigzag_global_perm(
        R * Tl, R)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _covered(R, Tl, layout, causal):
    """How often each (query, key) position pair is computed by the
    schedule's kernel calls, and each (rank, hop)'s unmasked area."""
    cover = np.zeros((R * Tl, R * Tl), int)
    area = np.zeros((R, R), int)
    for r in range(R):
        qp = CP.chunk_positions(r, R, Tl, layout)
        for s in range(R):
            kp = CP.chunk_positions((r - s) % R, R, Tl, layout)
            for c in CP.hop_schedule(r, s, R, Tl, layout, causal):
                nq = c.q.stop - c.q.start
                nk = c.kv.stop - c.kv.start
                vis = np.ones((nq, nk), bool)
                if c.causal:          # the kernel's bottom-right mask
                    vis = np.tril(vis, nk - nq)
                qi, ki = np.nonzero(vis)
                np.add.at(cover, (qp[c.q][qi], kp[c.kv][ki]), 1)
                area[r, s] += vis.sum()
    return cover, area


@pytest.mark.parametrize("R,T_", [(2, 16), (4, 32), (4, 64), (8, 64)])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("causal", [True, False])
def test_schedule_covers_every_unmasked_pair_once(R, T_, layout, causal):
    """The port's copy of JAX ``test_zigzag_covers_every_token_pair_once``
    at the level of kernel calls: every pair the mask keeps is computed
    exactly once, and no masked pair at all."""
    cover, _ = _covered(R, T_ // R, layout, causal)
    want = np.tril(np.ones_like(cover)) if causal else np.ones_like(cover)
    assert np.array_equal(cover, want)


@pytest.mark.parametrize("R,T_", [(4, 64), (8, 64)])
def test_zigzag_balances_per_hop_unmasked_work(R, T_):
    """The port's copy of the JAX test: under zigzag every rank's calls
    at a hop cover the same area (Tl²/2 off the diagonal); contiguous
    does not balance."""
    Tl = T_ // R
    _, area = _covered(R, Tl, "zigzag", True)
    assert (area[:, 1:] == Tl * Tl // 2).all()
    assert (area.max(0) == area.min(0)).all()
    _, area = _covered(R, Tl, "contiguous", True)
    assert (area.max(0) != area.min(0)).any()


def test_hop_schedule_calls_pinned():
    """The calls of each (rank, hop) at R 4, Tl 8 (C 4)."""
    full, a, b = slice(0, 8), slice(0, 4), slice(4, 8)
    H = CP.HopCall
    sched = {(r, s): CP.hop_schedule(r, s, 4, 8, "zigzag")
             for r in range(4) for s in range(4)}
    for r in range(4):
        assert sched[(r, 0)] == (H(full, full, True),)
        for s in range(1, 4):
            src = (r - s) % 4
            want = ((H(a, a, False), H(b, a, False)) if src < r
                    else (H(b, full, False),))
            assert sched[(r, s)] == want, (r, s)
    for r in range(4):
        for s in range(4):
            src = (r - s) % 4
            got = CP.hop_schedule(r, s, 4, 8, "contiguous")
            assert got == ((H(full, full, True),) if src == r else
                           (H(full, full, False),) if src < r else ())
            assert CP.hop_schedule(r, s, 4, 8, "zigzag", causal=False) \
                == (H(full, full, False),)
    for layout in ("contiguous", "zigzag"):
        for causal in (True, False):
            for r in range(4):
                n = sum(len(CP.hop_schedule(r, s, 4, 8, layout, causal))
                        for s in range(4))
                assert n == CP.hop_launches(r, 4, layout, causal)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("causal", [True, False])
def test_loopback_matches_one_device_attention(layout, causal):
    """The loopback ring of 4 virtual ranks (the card checks' witness of
    the ring) against the JAX package's dense attention, GQA, f32."""
    q, k, v, do = _inputs(1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = CP.ring_loopback(*leaves, 4, causal=causal, layout=layout,
                         impl="reference")
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    jo, vjp = jax.vjp(lambda q, k, v: jfa(q, k, v, causal=causal,
                                          impl="dense"),
                      *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_kernel_impl_on_cpu_tensors_raises():
    """``impl="kernel"`` takes the flash kernels or raises: no quiet
    fallback to the plain hop."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2))
    with pytest.raises(ValueError, match="take CUDA tensors"):
        CP.ring_loopback(q, k, v, 4, impl="kernel")
    with pytest.raises(ValueError, match="take CUDA tensors"):
        CP.ring_attention(q, k, v, axis=None, impl="kernel")
    with pytest.raises(ValueError, match="even per-rank chunk"):
        CP.chunk_positions(0, 4, 7, "zigzag")
    with pytest.raises(ValueError, match="not divisible by 2\\*cp"):
        CP.zigzag_global_perm(36, 4)
