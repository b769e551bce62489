"""The port's flash attention (plain version, CPU) and fused
cross-entropy vs the JAX package.

Flash attention is held to JAX ``flash_attention(impl="dense")`` (splash
does not run on the CPU), forward and gradients, for S = T and S > T
(bottom-right causal), with GQA. Contract (f32): rtol/atol 1e-5 — the
same einsum/softmax formulation on both sides, summed in another order.
The kernels are held to this plain version on the card
(``test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.fused import fused_softmax_cross_entropy as j_ce
from paddle_tpu.ops.pallas.flash_attention import flash_attention as j_fa
from paddle_tpu_torch.ops.fused import fused_softmax_cross_entropy as t_ce
from paddle_tpu_torch.ops.kernels import flash_attention as TFA

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("T,S,H,Hkv,causal", [
    (16, 16, 4, 2, True),     # S = T, GQA
    (6, 13, 4, 1, True),      # S > T: bottom-right offset, one kv head
    (8, 8, 2, 2, False),      # full mask
])
def test_flash_attention_matches_jax_dense(T, S, H, Hkv, causal):
    rng = np.random.RandomState(T * 100 + S)
    B, Dh = 2, 8
    q = rng.randn(B, T, H, Dh).astype(np.float32)
    k = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    ct = rng.randn(B, T, H, Dh).astype(np.float32)

    def jf(q, k, v):
        return jnp.vdot(j_fa(q, k, v, causal=causal, impl="dense"), ct)

    jo = j_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              causal=causal, impl="dense")
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = TFA.flash_attention(tq, tk, tv, causal=causal)
    (to * _t(ct)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Dh", [64, 128])
def test_prescale_matches_jax_bitwise(Dh):
    """The kernel path's pre-scale of q is splash's
    ``(q * sm_scale).astype(q.dtype)`` bit for bit on bf16 inputs, at the
    JAX package's default scale ``1 / np.sqrt(Dh)`` (a NumPy scalar, so
    both sides multiply in f32 and round once to bf16)."""
    rng = np.random.RandomState(Dh)
    q = (rng.randn(2, 37, 4, Dh) * 3).astype(np.float32)
    sm_scale = 1.0 / np.sqrt(Dh)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = np.asarray((jq * sm_scale).astype(jq.dtype)).view(np.uint16)
    got = TFA.prescale_q(_t(q).to(torch.bfloat16), sm_scale)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), want)


def test_kernel_path_hands_the_kernels_the_prescaled_q(monkeypatch):
    """The autograd Function pre-scales q once and gives that tensor to
    the forward, dq and dkv kernels; dq's launch gets sm_scale for the
    unscaled q's gradient. The kernels are stood in for here (they run
    only on the card)."""
    seen = {}

    def fwd(qs, k, v, causal):
        seen["fwd"] = qs
        B, T, H, _ = qs.shape
        return (TFA._dense_reference(qs, k, v, causal, 1.0),
                torch.zeros(B, H, T))

    def dq(qs, k, v, o, do, lse, causal, sm_scale):
        seen["dq"] = (qs, sm_scale)
        return torch.zeros_like(qs), torch.zeros_like(lse)

    def dkv(qs, k, v, do, lse, delta, causal):
        seen["dkv"] = qs
        return torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(TFA, "flash_attention_fwd", fwd)
    monkeypatch.setattr(TFA, "flash_attention_bwd_dq", dq)
    monkeypatch.setattr(TFA, "flash_attention_bwd_dkv", dkv)
    rng = np.random.RandomState(1)
    q = _t(rng.randn(1, 8, 4, 64).astype(np.float32)).bfloat16()
    k = _t(rng.randn(1, 8, 2, 64).astype(np.float32)).bfloat16()
    leaves = [t.requires_grad_() for t in (q, k, k.detach().clone())]
    scale = 1.0 / np.sqrt(64)
    TFA._FlashAttention.apply(*leaves, True, float(scale)).sum().backward()
    assert torch.equal(seen["fwd"], TFA.prescale_q(q.detach(), scale))
    assert seen["dq"][0] is seen["fwd"] and seen["dkv"] is seen["fwd"]
    assert seen["dq"][1] == float(scale)


def test_flash_attention_checks_shapes_and_impl():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="S >= T|S=4 < T=8"):
        TFA.flash_attention(q, torch.zeros(1, 4, 2, 16),
                            torch.zeros(1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        TFA.flash_attention(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="impl"):
        TFA.flash_attention(q, q, q, impl="dense")
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention(q, q, q, impl="kernel")


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_fused_cross_entropy_matches_jax(dtype):
    """Loss and gradient with ignore_index (-100): ignored positions get
    zero loss and zero gradient. f32 within 1e-5; bf16 logits (both sides
    keep the gradient in bf16) within one bf16 ulp of the largest
    gradient (2**-8 relative)."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 5, 37) * 4).astype(np.float32)
    labels = rng.randint(0, 37, (3, 5)).astype(np.int32)
    labels[0, 1] = labels[2, 4] = -100
    ct = rng.rand(3, 5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jl = jnp.asarray(logits).astype(jdt)

    def jf(lg):
        return jnp.vdot(j_ce(lg, jnp.asarray(labels)), ct)

    jloss = j_ce(jl, jnp.asarray(labels))
    jgrad = np.asarray(jax.grad(jf)(jl).astype(jnp.float32))
    tl = _t(logits).to(tdt).requires_grad_()
    tloss = t_ce(tl, _t(labels))
    (tloss * _t(ct)).sum().backward()
    assert tloss.dtype == torch.float32
    assert float(tloss.detach()[0, 1]) == 0.0 and not tl.grad[0, 1].any()
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    if dtype == np.float32:
        np.testing.assert_allclose(tl.grad.numpy(), jgrad, **TOL)
    else:
        scale = np.abs(jgrad).max()
        np.testing.assert_allclose(tl.grad.float().numpy(), jgrad, rtol=0,
                                   atol=scale * 2.0 ** -8)
