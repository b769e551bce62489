"""The port's grouped matmul vs the JAX package's: ``gmm`` with its
gradients, the weight-gradient product ``tgmm``, ``sort_and_pad_by_expert``
and ``moe_mlp_dropless`` with its gradients.

Inputs come from numpy with a seed and go through both; the JAX side runs
its Pallas kernels in interpret mode, as its own tests do, and the port
its plain versions (CPU tensors). Contract (f32): rtol/atol 1e-5;
``sort_and_pad_by_expert`` exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import grouped_matmul as JG
from paddle_tpu_torch.ops.kernels import grouped_matmul as TG

TOL = dict(rtol=1e-5, atol=1e-5)

# (tile_expert, E, K, N, tile_m): the JAX package's two cases, one with a
# ragged column count, and one whose row tiles are two of the card
# kernel's 128-row blocks
GMM_CASES = {
    "four_experts": ([0, 1, 1, 3], 4, 64, 128, 128),
    "empty_expert": ([0, 2, 2], 3, 128, 128, 128),
    "ragged_n": ([1, 1, 2], 3, 64, 72, 128),
    "tile_m_256": ([0, 2], 3, 64, 136, 256),
}


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_and_grads_match_jax(case, trans):
    """Forward, dlhs and drhs against ``jax.vjp`` of the JAX ``gmm``; with
    ``trans`` the port reads the weight ``[E, N, K]`` transposed where JAX
    is given ``swapaxes`` of it."""
    te, E, K, N, TM = GMM_CASES[case]
    rs = np.random.RandomState(len(case))
    M = TM * len(te)
    # unit-scale outputs and gradients (the weight as initialised, the
    # cotangent over an expert's rows), so the absolute tolerance means
    # the same at every reduction length
    lhs = rs.randn(M, K).astype(np.float32)
    w = rs.randn(E, N, K) if trans else rs.randn(E, K, N)
    w = (w / np.sqrt(K)).astype(np.float32)
    ct = (rs.randn(M, N) / np.sqrt(TM)).astype(np.float32)
    te_np = np.asarray(te, np.int32)

    def jfn(l, r):
        r = jnp.swapaxes(r, 1, 2) if trans else r
        return JG.gmm(l, r, jnp.asarray(te_np), TM, 128)

    want, vjp = jax.vjp(jfn, jnp.asarray(lhs), jnp.asarray(w))
    dl_want, dw_want = vjp(jnp.asarray(ct))
    tl, tw = _t(lhs, True), _t(w, True)
    got = TG.gmm(tl, tw, _t(te_np), TM, trans=trans)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tl.grad.numpy(), dl_want, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), dw_want, **TOL)
    for e in set(range(E)) - set(te):       # no tile: exactly 0
        assert not tw.grad[e].any()


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_tgmm_matches_jax_tgmm_call(case):
    """``tgmm`` against the JAX weight-gradient kernel in interpret mode
    (f32 output), experts with no tile 0."""
    te, E, K, N, TM = GMM_CASES[case]
    rs = np.random.RandomState(7)
    M = TM * len(te)
    lhs = rs.randn(M, K).astype(np.float32)
    g = (rs.randn(M, N) / np.sqrt(TM)).astype(np.float32)   # unit scale
    want = JG._tgmm_call(jnp.asarray(lhs), jnp.asarray(g),
                         jnp.asarray(te, jnp.int32), E, TM,
                         N if N % 128 else 128, interpret=True)
    got = TG.tgmm(_t(lhs), _t(g), _t(np.asarray(te, np.int32)), E, TM)
    assert got.shape == (E, K, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gmm_rejects_unsorted_tile_expert_like_jax():
    lhs = torch.zeros(384, 64)
    rhs = torch.zeros(3, 64, 128)
    with pytest.raises(ValueError, match="non-decreasing"):
        JG.gmm(jnp.zeros((384, 64)), jnp.zeros((3, 64, 128)),
               jnp.array([0, 1, 0], jnp.int32), 128, 128)
    with pytest.raises(ValueError, match="non-decreasing"):
        TG.gmm(lhs, rhs, torch.tensor([0, 1, 0], dtype=torch.int32), 128)


def test_kernel_impls_refuse_cpu_tensors_and_bad_arguments():
    lhs, rhs = torch.zeros(256, 64), torch.zeros(2, 64, 128)
    te = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TG.gmm(lhs, rhs, te, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        TG.tgmm(lhs, torch.zeros(256, 128), te, 2, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        TG.gmm(lhs, rhs, te, impl="pallas")
    with pytest.raises(ValueError, match="tile_expert"):
        TG.gmm(lhs, rhs, te[:1])
    with pytest.raises(ValueError, match="K="):
        TG.gmm(lhs, rhs, te, trans=True)
    before = (TG.gmm.launches, TG.tgmm.launches)
    TG.gmm(lhs, rhs, te)
    TG.tgmm(lhs, torch.zeros(256, 128), te, 2)
    assert (TG.gmm.launches, TG.tgmm.launches) == before


@pytest.mark.parametrize("A,E,tile_m,seed", [
    (6, 3, 4, 0), (37, 5, 8, 1), (64, 4, 8, 2), (200, 7, 128, 3),
    (1024, 60, 128, 4)])
def test_sort_and_pad_matches_jax_exactly(A, E, tile_m, seed):
    rs = np.random.RandomState(seed)
    eids = rs.randint(0, E, A).astype(np.int32)
    if seed == 4:
        eids[eids >= E - 5] = 0          # trailing experts empty
    want = JG.sort_and_pad_by_expert(jnp.asarray(eids), E, tile_m)
    got = TG.sort_and_pad_by_expert(torch.from_numpy(eids), E, tile_m)
    assert got[3] == want[3]
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _moe_inputs(seed, S=64, D=32, F=48, E=4, k=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(S, D).astype(np.float32)
    ws = [(rs.randn(*shape) * 0.1).astype(np.float32)
          for shape in ((E, D, F), (E, D, F), (E, F, D))]
    logits = rs.randn(S, E).astype(np.float32)
    cw, eids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    return x, np.asarray(eids), np.asarray(cw), ws


@pytest.mark.parametrize("tile_m", [8, 128])
def test_moe_mlp_dropless_and_grads_match_jax(tile_m):
    """Forward, and the gradients of x, the combine weights and the three
    expert weights, against the JAX dropless MoE FFN."""
    x, eids, cw, ws = _moe_inputs(tile_m)
    ct = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jfn(x, cw, wg, wu, wd):
        y = JG.moe_mlp_dropless(x, jnp.asarray(eids), cw, wg, wu, wd,
                                tile_m=tile_m, tile_n=16)
        return jnp.vdot(y, jnp.asarray(ct)), y

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *map(jnp.asarray, (x, cw, *ws)))
    leaves = [_t(a, True) for a in (x, cw, *ws)]
    got = TG.moe_mlp_dropless(leaves[0], _t(eids), *leaves[1:],
                              tile_m=tile_m)
    (got * _t(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for leaf, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, **TOL)
