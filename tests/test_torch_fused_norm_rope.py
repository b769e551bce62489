"""The port's fused RMSNorm and RoPE (plain versions, CPU) vs the JAX
package's Pallas kernels run in interpret mode.

Inputs are seeded numpy arrays handed to both. Contract (f32): values
and VJPs within rtol/atol 1e-5 (both sides compute in f32; the sums run
in another order and the transcendentals are other implementations, a
few f32 ulps apart). On the CPU the wrappers take the plain versions
because the tensors lie on the CPU; the kernels themselves are held to
these plain versions on the card (``test_torch_cuda_kernels.py``,
``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_norm_rope as JF
from paddle_tpu_torch.ops.kernels import fused_norm_rope as TF

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("shape", [(4, 16, 32), (3, 8, 64)])
def test_fused_rms_norm_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    w = (rng.randn(shape[-1]) + 1.0).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)

    def jf(x, w):
        return jnp.vdot(JF.fused_rms_norm(x, w, 1e-5), ct)

    jy = JF.fused_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    jdx, jdw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx = _t(x).requires_grad_()
    tw = _t(w).requires_grad_()
    ty = TF.fused_rms_norm(tx, tw, 1e-5)
    (ty * _t(ct)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


# (N, D, JAX tile_n): the 32-row case; N off the 16-row dw chunk of the
# port's kernel (RMS_DW_CHUNK + 1, and 33 with a D that is no multiple of
# 256); one row
@pytest.mark.parametrize("N,D,tile", [(32, 64, 8), (17, 64, 17),
                                      (33, 40, 11), (1, 64, 1)])
def test_rms_norm_kernel_pieces_match_jax_calls(N, D, tile):
    """The plain forward and backward pieces (rstd, dx, f32 dw) against
    the JAX package's two Pallas calls directly."""
    rng = np.random.RandomState(1)
    x = (rng.randn(N, D) * 2).astype(np.float32)
    w = (rng.randn(D) + 1).astype(np.float32)
    g = rng.randn(N, D).astype(np.float32)
    jy, jr = JF._rms_fwd_call(jnp.asarray(x), jnp.asarray(w), 1e-5, tile,
                              True)
    jdx, jdw = JF._rms_bwd_call(jnp.asarray(x), jnp.asarray(w), jr,
                                jnp.asarray(g), 1e-5, tile, True)
    ty, tr = TF.rms_norm_fwd(_t(x), _t(w), 1e-5)
    tdx, tdw = TF.rms_norm_bwd(_t(x), _t(w), tr, _t(g))
    assert tr.shape == (N, 1) and tr.dtype == torch.float32
    assert tdw.dtype == torch.float32
    for got, want in ((ty, jy), (tr, jr), (tdx, jdx), (tdw, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N,rows", [(0, 1), (1, 1), (15, 1), (16, 1),
                                    (17, 2), (2048, 128)])
def test_rms_bwd_workspace_has_a_row_per_dw_chunk(N, rows):
    """The backward kernel's f32 scratch: one row of dw column sums per
    fixed chunk of RMS_DW_CHUNK = 16 rows (ceil(N / 16)), one for N 0;
    its shape depends on N and D alone."""
    assert TF.RMS_DW_CHUNK == 16
    assert TF.rms_bwd_workspace(N, 4096) == (rows, 4096)
    assert TF.rms_bwd_workspace(N, 40) == (rows, 40)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_fused_rope_matches_jax(theta):
    """Forward and backward (−positions) on GQA-shaped q/k with offset
    positions, against the JAX kernel's roll-based formula."""
    rng = np.random.RandomState(2)
    B, T, H, Hkv, Dh = 2, 16, 4, 2, 16
    q = rng.randn(B, T, H, Dh).astype(np.float32)
    k = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    pos = (np.arange(T)[None] + np.array([[0], [2031]])).astype(np.int32)
    cq = rng.randn(*q.shape).astype(np.float32)
    ck = rng.randn(*k.shape).astype(np.float32)

    def jf(q, k):
        oq, ok = JF.fused_rope(q, k, jnp.asarray(pos), theta, 8)
        return jnp.vdot(oq, cq) + jnp.vdot(ok, ck)

    jq, jk = JF.fused_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           theta, 8)
    jdq, jdk = jax.grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))

    tq, tk = _t(q).requires_grad_(), _t(k).requires_grad_()
    oq, ok = TF.fused_rope(tq, tk, _t(pos), theta)
    ((oq * _t(cq)).sum() + (ok * _t(ck)).sum()).backward()
    for got, want in ((oq, jq), (ok, jk), (tq.grad, jdq), (tk.grad, jdk)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_rope_backward_inverts_forward():
    """Rotating by −positions after +positions returns the input (f32,
    within 1e-5 at positions up to 2047)."""
    rng = np.random.RandomState(3)
    q = _t(rng.randn(1, 64, 2, 32).astype(np.float32))
    k = _t(rng.randn(1, 64, 1, 32).astype(np.float32))
    pos = _t((np.arange(64) * 32 + 31)[None].astype(np.int32))
    oq, ok = TF.rope_rotate(q, k, pos, 500000.0)
    bq, bk = TF.rope_rotate(oq, ok, -pos, 500000.0)
    np.testing.assert_allclose(bq.numpy(), q.numpy(), **TOL)
    np.testing.assert_allclose(bk.numpy(), k.numpy(), **TOL)


def test_wrappers_reject_bad_impl_and_count_no_cpu_launches():
    x = torch.ones(2, 8)
    w = torch.ones(8)
    before = (TF.rms_norm_fwd.launches, TF.rope_rotate.launches)
    TF.fused_rms_norm(x, w)
    TF.fused_rope(x.reshape(1, 2, 1, 8), x.reshape(1, 2, 1, 8),
                  torch.zeros(1, 2, dtype=torch.int32))
    assert (TF.rms_norm_fwd.launches, TF.rope_rotate.launches) == before
    with pytest.raises(ValueError, match="impl"):
        TF.fused_rms_norm(x, w, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        TF.fused_rms_norm(x, w, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        TF.rope_rotate(x.reshape(1, 2, 1, 8), x.reshape(1, 2, 1, 8),
                       torch.zeros(1, 2, dtype=torch.int32), 1e4,
                       impl="kernel")
