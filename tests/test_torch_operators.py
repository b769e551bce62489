"""The kernel entries as PyTorch operators (``torch.ops.paddle_tpu.*``).

Every entry of ``paddle_tpu_torch/ops/kernels`` is a
``torch.library.custom_op``; on CPU tensors its body runs the plain
version. Held here, on tiny shapes in float32 and bfloat16:

* ``torch.library.opcheck`` (schema, fake against real outputs' shape,
  dtype and strides, the autograd registration, and an AOT trace with
  dynamic shapes);
* each operator's outputs equal its plain function's bitwise, and the
  eager wrapper's (which calls the plain function directly, no
  dispatcher);
* the differentiable operators' registered gradients equal the eager
  autograd Functions' bitwise (one formula serves both), and the
  explicit plain flash backward (dq, dk, dv in the softmax-backward
  form) is held to the JAX package's flash gradients at rtol/atol 1e-5
  in f32;
* eager calls never reach the operator; a captured call does.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.ops.kernels import _op
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_norm_rope as NR
from paddle_tpu_torch.ops.kernels import grouped_matmul as GM
from paddle_tpu_torch.ops.kernels import int8_matmul as I8
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as RPA

OPS = torch.ops.paddle_tpu
DTYPES = [torch.float32, torch.bfloat16]
NEW_OPERATORS = ("rms_norm_fwd", "rms_norm_bwd", "rope",
                 "flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "ragged_paged_attention_packed",
                 "paged_attention", "paged_attention_stats", "int8_matmul",
                 "gmm", "tgmm")


def _rand(rs, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (rs.randn(*shape) * scale).astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# cases: (args, indices of differentiable inputs, plain function)
# ---------------------------------------------------------------------------

def _rms_fwd(dt, rs):
    return ((_rand(rs, (5, 16), dt), _rand(rs, (16,), dt), 1e-5, "auto"),
            (0, 1), lambda a: NR._rms_fwd_plain(*a[:3]))


def _rms_bwd(dt, rs):
    x = _rand(rs, (5, 16), dt)
    w = _rand(rs, (16,), dt)
    _, rstd = NR._rms_fwd_plain(x, w, 1e-5)
    return ((x, w, rstd, _rand(rs, (5, 16), dt), "auto"), (),
            lambda a: NR._rms_bwd_plain(*a[:4]))


def _rope(dt, rs):
    pos = torch.from_numpy(rs.randint(0, 64, (2, 4)).astype(np.int64))
    return ((_rand(rs, (2, 4, 4, 16), dt), _rand(rs, (2, 4, 2, 16), dt),
             pos, 10000.0, "auto"), (0, 1),
            lambda a: NR._rope_plain(*a[:4]))


def _flash_inputs(dt, rs, T=6, S=8):
    q = _rand(rs, (1, T, 4, 16), dt)
    k = _rand(rs, (1, S, 2, 16), dt)
    v = _rand(rs, (1, S, 2, 16), dt)
    scale = 0.25
    return q, FA.prescale_q(q, scale), k, v, scale


def _flash_fwd(dt, rs):
    q, qs, k, v, scale = _flash_inputs(dt, rs)
    return ((q, qs, k, v, True, scale, "auto"), (0, 2, 3),
            lambda a: FA._fwd_plain(a[1], a[2], a[3], a[4]))


def _flash_dq(dt, rs):
    q, qs, k, v, scale = _flash_inputs(dt, rs)
    o, lse = FA._fwd_plain(qs, k, v, True)
    do = _rand(rs, o.shape, dt)
    return ((qs, k, v, o, do, lse, True, scale, "auto"), (),
            lambda a: FA._bwd_dq_plain(*a[:8]))


def _flash_dkv(dt, rs):
    q, qs, k, v, scale = _flash_inputs(dt, rs)
    o, lse = FA._fwd_plain(qs, k, v, True)
    do = _rand(rs, o.shape, dt)
    _, delta = FA._bwd_dq_plain(qs, k, v, o, do, lse, True, scale)
    return ((qs, k, v, do, lse, delta, True, "auto"), (),
            lambda a: FA._bwd_dkv_plain(*a[:7]))


def _ragged(dt, rs):
    S, ps, pps = 3, 4, 3
    tables = np.arange(1, 1 + S * pps).reshape(S, pps).astype(np.int32)
    _, meta = TL.pack_tick([(0, 1, 5)], [(1, np.arange(4), 2),
                                         (2, np.arange(3), 0)],
                           tables, ps, "cpu")
    kp = _rand(rs, (2, 1 + S * pps, ps, 16), dt)
    vp = _rand(rs, (2, 1 + S * pps, ps, 16), dt)
    T = meta["tok_slot"].shape[0]
    args = (_rand(rs, (T, 4, 16), dt), kp, vp, meta["tok_slot"],
            meta["tok_qoff"], meta["q_len"], meta["kv_len"],
            meta["tables"], 0.25, "auto")
    return args, (), lambda a: RPA._packed_impl(*a[:9])


def _paged_args(dt, rs):
    return (_rand(rs, (2, 4, 16), dt), _rand(rs, (2, 5, 4, 16), dt),
            _rand(rs, (2, 5, 4, 16), dt),
            torch.tensor([5, 8], dtype=torch.int32),
            torch.tensor([[1, 2], [3, 4]], dtype=torch.int32), 0.25, "auto")


def _paged(dt, rs):
    return (_paged_args(dt, rs), (),
            lambda a: PA.paged_attention_reference(*a[:6])[0])


def _paged_stats(dt, rs):
    return (_paged_args(dt, rs), (),
            lambda a: PA.paged_attention_reference(*a[:6]))


def _int8(dt, rs):
    q = torch.from_numpy(rs.randint(-127, 128, (32, 48)).astype(np.int8))
    scale = torch.from_numpy(rs.rand(48).astype(np.float32) / 100)
    return ((_rand(rs, (3, 32), dt), q, scale, "auto"), (),
            lambda a: I8.int8_matmul_reference(*a[:3]))


_TILES = torch.tensor([0, 0, 2, 2], dtype=torch.int32)


def _gmm(dt, rs):
    return ((_rand(rs, (16, 8), dt), _rand(rs, (3, 8, 24), dt), _TILES, 4,
             False, "auto"), (0, 1), lambda a: GM.gmm_reference(*a[:5]))


def _gmm_trans(dt, rs):
    return ((_rand(rs, (16, 8), dt), _rand(rs, (3, 24, 8), dt), _TILES, 4,
             True, "auto"), (0, 1), lambda a: GM.gmm_reference(*a[:5]))


def _tgmm(dt, rs):
    return ((_rand(rs, (16, 8), dt), _rand(rs, (16, 24), dt), _TILES, 3, 4,
             "auto"), (),
            lambda a: GM.tgmm_reference(*a[:5]).to(a[0].dtype))


CASES = {"rms_norm_fwd": _rms_fwd, "rms_norm_bwd": _rms_bwd, "rope": _rope,
         "flash_attention_fwd": _flash_fwd,
         "flash_attention_bwd_dq": _flash_dq,
         "flash_attention_bwd_dkv": _flash_dkv,
         "ragged_paged_attention_packed": _ragged,
         "paged_attention": _paged, "paged_attention_stats": _paged_stats,
         "int8_matmul": _int8, "gmm": _gmm, "gmm-trans": _gmm_trans,
         "tgmm": _tgmm}


def _case(name, dtype, grad=False):
    args, diff, plain = CASES[name](dtype, np.random.RandomState(7))
    if grad:
        args = tuple(a.requires_grad_() if i in diff else a
                     for i, a in enumerate(args))
    return getattr(OPS, name.split("-")[0]).default, args, plain


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _bits_equal(got, want):
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.detach(), w.detach(), rtol=0, atol=0,
                                   equal_nan=True)


def test_every_entry_is_an_operator():
    for name in NEW_OPERATORS + ("matmul_bias_act",):
        assert hasattr(OPS, name), name
    assert sorted(CASES) == sorted(NEW_OPERATORS + ("gmm-trans",))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(name, dtype):
    op, args, _ = _case(name, dtype, grad=True)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_operator_equals_plain_bitwise(name, dtype):
    op, args, plain = _case(name, dtype)
    out = op(*args)
    _bits_equal(out, plain(args))
    for t in _as_tuple(out):
        assert t.is_contiguous()
    # the "reference" impl is the plain version too
    _bits_equal(op(*args[:-1], "reference"), out)


@pytest.mark.parametrize("name", ["int8_matmul", "gmm", "rope",
                                  "paged_attention"])
def test_kernel_impl_stays_strict_on_cpu(name):
    op, args, _ = _case(name, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        op(*args[:-1], "kernel")


# ---------------------------------------------------------------------------
# eager wrappers: the same values, no dispatcher
# ---------------------------------------------------------------------------

def _wrapper_outputs(name, args):
    if name == "rms_norm_fwd":
        return NR.rms_norm_fwd(*args)
    if name == "rms_norm_bwd":
        return NR.rms_norm_bwd(*args)
    if name == "rope":
        return NR.rope_rotate(*args)
    if name == "flash_attention_fwd":
        return FA._fwd_run(*args)
    if name == "ragged_paged_attention_packed":
        return RPA.ragged_paged_attention_packed(*args)
    if name == "paged_attention":
        return PA.paged_attention(*args)
    if name == "paged_attention_stats":
        return PA.paged_attention_stats(*args)
    if name == "int8_matmul":
        return I8.int8_matmul(*args)
    if name.startswith("gmm"):
        lhs, rhs, te, tm, trans, impl = args
        return GM.gmm(lhs, rhs, te, tm, trans=trans, impl=impl)
    if name == "tgmm":
        return GM.tgmm(*args)
    raise KeyError(name)


@pytest.mark.parametrize("name", [n for n in sorted(CASES) if not
                                  n.startswith("flash_attention_bwd")])
def test_eager_wrapper_skips_the_dispatcher(name, monkeypatch):
    """The eager call equals the operator's output bitwise and never
    calls the operator object (each module's ``_*op``)."""
    op, args, _ = _case(name, torch.bfloat16)
    want = op(*args)

    def refuse(*a, **k):
        raise AssertionError("an eager call reached the operator")

    for mod in (NR, FA, RPA, PA, I8, GM):
        for attr in list(vars(mod)):
            if attr.startswith("_") and attr.endswith("op") and \
                    hasattr(getattr(mod, attr), "register_fake"):
                monkeypatch.setattr(mod, attr, refuse)
    _bits_equal(_wrapper_outputs(name, args), want)


def test_captured_call_reaches_the_operator():
    """Under ``to_static`` the wrapper calls the operator: the captured
    graph holds it as one node."""
    op, args, _ = _case("int8_matmul", torch.float32)
    seen = []

    def backend(gm, example_inputs):
        seen.extend(str(n.target) for n in gm.graph.nodes
                    if n.op == "call_function")
        return gm.forward

    f = TJ.to_static(lambda x, q, s: I8.int8_matmul(x[None], q, s)[0],
                     backend=backend)
    _bits_equal(f(*args[:3]), op(*args))
    assert seen.count("paddle_tpu.int8_matmul.default") == 1


# ---------------------------------------------------------------------------
# gradients: one formula for the operator and the eager Function
# ---------------------------------------------------------------------------

def _grads_of(fn, args, diff, rs):
    leaves = [a.detach().clone().requires_grad_() if i in diff else a
              for i, a in enumerate(args)]
    outs = _as_tuple(fn(*leaves))
    cots = [_rand(rs, o.shape, o.dtype) for o in outs if
            o.is_floating_point() and o.requires_grad]
    live = [o for o in outs if o.is_floating_point() and o.requires_grad]
    torch.autograd.backward(live, cots)
    return [leaves[i].grad for i in diff]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name,direct", [
    ("rms_norm_fwd", NR._RMSNorm), ("rope", NR._RoPE),
    ("flash_attention_fwd", FA._FlashAttention), ("gmm", GM._GMM),
    ("gmm-trans", GM._GMM)])
def test_registered_gradient_equals_eager_function(name, direct, dtype):
    op, args, _ = _case(name, dtype)
    diff = {"rms_norm_fwd": (0, 1), "rope": (0, 1),
            "flash_attention_fwd": (0, 2, 3)}.get(name.split("-")[0],
                                                  (0, 1))
    got = _grads_of(op, args, diff, np.random.RandomState(3))
    want = _grads_of(direct.apply, args, diff, np.random.RandomState(3))
    for g, w in zip(got, want):
        _bits_equal(g, w)


def test_plain_flash_backward_matches_jax_gradients():
    """The operator path (prescale, the forward operator, its registered
    backward over the plain dq / dkv) against ``jax.grad`` of the JAX
    package's flash attention (its dense path on the CPU), f32, causal
    GQA with S > T."""
    rs = np.random.RandomState(11)
    q = rs.randn(2, 6, 4, 16).astype(np.float32)
    k = rs.randn(2, 9, 2, 16).astype(np.float32)
    v = rs.randn(2, 9, 2, 16).astype(np.float32)
    do = rs.randn(2, 6, 4, 16).astype(np.float32)

    def jloss(q, k, v):
        return (JFA.flash_attention(q, k, v, causal=True) * do).sum()

    jo = JFA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    scale = 1.0 / np.sqrt(16)
    qs = FA.prescale_q(tq.detach(), scale)
    o, _ = OPS.flash_attention_fwd(tq, qs, tk, tv, True, float(scale),
                                   "auto")
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_gmm_raises_eagerly_on_unsorted_tiles():
    """The JAX ``gmm``'s sorted-tiles precondition now sits in the
    operator's CPU body, and still raises on an eager call."""
    op, args, _ = _case("gmm", torch.float32)
    lhs, rhs, _, tm, trans, impl = args
    bad = torch.tensor([2, 2, 0, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="non-decreasing"):
        GM.gmm(lhs, rhs, bad, tm, impl=impl)
    with pytest.raises(ValueError, match="non-decreasing"):
        op(lhs, rhs, bad, tm, trans, impl)
    # tgmm keeps no such precondition
    GM.tgmm(lhs, lhs, bad, 3, tm)


def test_register_all_registers_every_operator():
    """In a fresh process, ``register_all`` alone registers every
    operator (``jit.load`` calls it before it reads a program)."""
    probe = ("import torch\n"
             "from paddle_tpu_torch.ops.kernels._op import register_all\n"
             f"names = {NEW_OPERATORS + ('matmul_bias_act',)!r}\n"
             "before = [hasattr(torch.ops.paddle_tpu, n) for n in names]\n"
             "register_all()\n"
             "after = [hasattr(torch.ops.paddle_tpu, n) for n in names]\n"
             "print(any(before), all(after))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["False", "True"], out.stdout
