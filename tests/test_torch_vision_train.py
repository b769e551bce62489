"""The port's vision train step vs the JAX package's: BatchNorm2D and
Dropout in training, the key stream, O1 ``auto_cast``, ``cross_entropy``,
``Momentum``, ``make_train_step`` on ResNet-18 / ResNet-50 and the zoo,
and the train-time transforms (``prepare_training``).

The JAX step is ``tools/resnet_bench.py``'s (``_bind`` +
``jax.value_and_grad`` + ``optax.sgd(0.1, momentum=0.9)``), the model
built by the JAX package from ``pt.seed(0)`` and its ``state_dict``
handed to the port through ``params_from_jax``; inputs are numpy arrays
from a seed.

O1 on the JAX side: the JAX package defines the O1 decision
(``paddle_tpu.amp.auto_cast.amp_transform_args`` over its white and
black lists) but its op dispatch never calls it, so under its
``auto_cast(True)`` alone every dtype stays f32. ``jax_o1()`` applies
that function at the JAX dispatch (``ops.registry.call_op``) for the
``with`` block, here in the test; nothing in the JAX package changes.

Contract (each bound stated where it is asserted):

* BN training, f32: output, batch mean and variance, running statistics
  after 1 and 3 calls within rtol 1e-5 (atol 1e-6 for values near 0);
  bf16: the output within one bf16 ulp of the normalised value at each
  channel's scale times |γ| (the rounding point before the affine;
  1e-6 more for the f32 affine), dtypes equal. B·H·W = 8, so an
  unbiased running variance (8/7 larger) fails. The backward: f32
  within rtol 1e-5; from a bf16 input, the input's gradient within one
  bf16 ulp at each channel's scale, γ's and β's within rtol 1e-5.
* O1's cast layers (conv with and without a bias, ``Linear``): the bf16
  output and the gradients of the f32 input and parameters within one
  bf16 ulp at the tensor's scale (the bias's against the exact sum of
  its bf16 cotangent).
* Dropout: the ``Generator`` key sequence, masks and outputs bitwise.
* ``cross_entropy``: loss and gradient within rtol 1e-5.
* ``Momentum``: three updates bitwise against ``pt.optimizer.Momentum``
  and ``optax.sgd`` op by op; within four f32 ulps at the parameters'
  scale of the jitted ``optax.sgd``, where XLA's CPU backend contracts a
  product and a sum into a fused multiply-add.
* The train step (ResNet-18, ResNet-50, B 4, 32², 10 classes, lr 0.1):
  three steps in f64 on both sides hold its arithmetic (every loss rtol
  1e-5; step 1's gradients within 1e-5 of their scale, parameters atol
  3e-5, buffers 1e-5; after step 3 parameters and buffers within 5e-4
  of their scale: at this lr and batch the step diverges). One step in
  f32 and one in O1 bf16 are as accurate as the JAX step in that
  precision: the distance from the f64 step within ``COND`` times the
  JAX step's, or the f32 floors. At 4 images the deep BNs normalise
  over 4-16 values a channel: f32 resolves ResNet-50's gradients to
  ~8e-2 of their scale, bf16 ResNet-18's to their own scale, on both
  sides.
* The O1 step against the JAX O1 step at ``O1_SIZES`` (ResNet-18 B 8,
  64²; ResNet-50 B 16, 128²), where its loss is conditioned: the
  losses within ``BF16_LOSS_REL``, the gradients and the update in
  direction and size (``O1_*``: a zeroed, halved or sign-flipped
  gradient fails), the buffers within 0.05 / 0.15 of their scale.
* The zoo's train steps: ``tests/test_torch_vision_train_zoo.py``.
"""
import contextlib
import importlib

import numpy as np
import optax
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.analysis.framework import default_rewrites
from paddle_tpu.analysis.rewrite import count_matches
from paddle_tpu.analysis.rewrite_conv import resnet_rewrite_targets
from paddle_tpu.autograd import tape as _tape
from paddle_tpu.core import generator as jgen
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import registry as _registry
from paddle_tpu.static.nn import _bind
from paddle_tpu.vision import models as JM
from paddle_tpu_torch import amp as TAMP
from paddle_tpu_torch.analysis import fold_conv_bn, prepare_training
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.models import _layers
from paddle_tpu_torch.nn.functional import cross_entropy, dropout
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision import train as TT

JAMP = importlib.import_module("paddle_tpu.amp.auto_cast")
jax_bn_train = importlib.import_module(
    "paddle_tpu.nn.functional.norm")._batch_norm_train

LR, MOM = 0.1, 0.9
# the O1 step's loss against the JAX O1 step's, relative, at
# ``O1_SIZES`` (measured 2.1e-3 for ResNet-18, 1.4e-3 for ResNet-50)
BF16_LOSS_REL = 1e-2


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def jax_o1():
    """JAX ``auto_cast(True)`` with its ``amp_transform_args`` applied to
    every op's floating Tensor inputs at dispatch (module docstring)."""
    real = _registry.call_op

    def call_op(name, fn, args, kwargs, differentiable=True):
        dt = JAMP.amp_transform_args(name, None)
        if dt is not None:
            def cast(t):
                if isinstance(t, Tensor) and jnp.issubdtype(t._data.dtype,
                                                            jnp.floating):
                    return Tensor(t._data.astype(dt),
                                  stop_gradient=t.stop_gradient)
                return t
            args = tuple(_registry._map_structure(cast, a) for a in args)
            kwargs = {k: _registry._map_structure(cast, v)
                      for k, v in kwargs.items()}
        return real(name, fn, args, kwargs, differentiable)

    with pytest.MonkeyPatch.context() as mp, pt.amp.auto_cast(True):
        mp.setattr(_registry, "call_op", call_op)
        yield


def _jloss(out, y):
    """``resnet_bench``'s loss on the JAX side (GoogLeNet: with its
    auxiliary heads, as ``tests/test_vision_zoo.py`` writes it)."""
    ce = JF.cross_entropy
    if isinstance(out, tuple):
        return (ce(out[0], y).mean() + 0.3 * ce(out[1], y).mean()
                + 0.3 * ce(out[2], y).mean())
    return ce(out.astype("float32"), y).mean()


class JaxStep:
    """``resnet_bench``'s step over a JAX model: ``run(x, y, n)`` takes
    ``n`` steps and returns each step's loss, the first step's gradients,
    and the parameters and buffers after step 1 and step n, by name."""

    def __init__(self, model, amp=False, jit=True):
        self.model = model
        self.params = model.parameters()
        self.bufs = list(model.buffers())
        self.pnames = [n for n, _ in model.named_parameters()]
        self.bnames = [n for n, _ in model.named_buffers()]
        opt = optax.sgd(LR, momentum=MOM)
        params, bufs = self.params, self.bufs

        def loss_arrays(parrs, barrs, x, y):
            ctx = jax_o1() if amp else contextlib.nullcontext()
            with _bind(params, parrs), _bind(bufs, barrs), \
                    _tape.no_grad(), ctx:
                out = model(Tensor(x))
                loss = _jloss(out, Tensor(y))
                new_b = [b._data for b in bufs]
            return loss.data, new_b

        def step(parrs, barrs, opt_state, x, y):
            (loss, new_b), grads = jax.value_and_grad(
                loss_arrays, has_aux=True)(parrs, barrs, x, y)
            updates, opt_state = opt.update(grads, opt_state, parrs)
            parrs = optax.apply_updates(parrs, updates)
            return parrs, new_b, opt_state, loss, grads

        self.opt = opt
        self.step = jax.jit(step) if jit else step

    def run(self, x, y, n, dtype=np.float32):
        with jax.enable_x64(dtype == np.float64):
            return self._run(x.astype(dtype), y, n, dtype)

    def _run(self, x, y, n, dtype):
        parrs = [jnp.asarray(p._data, dtype) for p in self.params]
        barrs = [jnp.asarray(b._data, dtype) for b in self.bufs]
        opt_state = self.opt.init(parrs)
        losses, rec = [], {}
        for i in range(n):
            parrs, barrs, opt_state, loss, grads = self.step(
                parrs, barrs, opt_state, x, y)
            losses.append(float(loss))
            if i == 0:
                rec["grads"] = self._named(self.pnames, grads)
                rec["params1"] = self._named(self.pnames, parrs)
                rec["bufs1"] = self._named(self.bnames, barrs)
        rec.update(losses=losses, params=self._named(self.pnames, parrs),
                   bufs=self._named(self.bnames, barrs))
        return rec

    @staticmethod
    def _named(names, arrs):
        return {n: np.asarray(a, np.float64) for n, a in zip(names, arrs)}


def port_of(jmodel, factory, kwargs):
    """The port's model with the JAX model's state."""
    state = {k: np.array(v._data) for k, v in jmodel.state_dict().items()}
    port = getattr(TM, factory)(device="cpu", **kwargs)
    port.load_state_dict(TM.params_from_jax(state, device="cpu"))
    return port


def port_run(model, x, y, n, amp=False, loss_fn=None, generator=None,
             dtype=torch.float32):
    """The port's step, ``n`` times: the same record as ``JaxStep.run``,
    the gradients read before the step clears them."""
    model.to(dtype)
    step = TT.make_train_step(model, lr=LR, momentum=MOM, amp=amp,
                              loss_fn=loss_fn, generator=generator,
                              device="cpu")
    opt = step.optimizer
    real = opt.step
    names = {id(p): n for n, p in model.named_parameters()}
    rec = {}

    def spy():
        if "grads" not in rec:
            rec["grads"] = {names[id(p)]: p.grad.double().numpy().copy()
                            for p in opt._param_list}
        real()

    opt.step = spy
    xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y).long()
    losses = []
    for i in range(n):
        losses.append(float(step(xt, yt)))
        if i == 0:
            rec["params1"] = _state(model, params=True)
            rec["bufs1"] = _state(model, params=False)
    rec.update(losses=losses, params=_state(model, params=True),
               bufs=_state(model, params=False))
    return rec


def _state(model, params):
    items = model.named_parameters() if params else model.named_buffers()
    return {n: t.detach().double().numpy().copy() for n, t in items}


def check_step(got, want, grad_tol=1e-5, param_atol=3e-5, buf_tol=1e-5,
               loss_rtol=1e-5, last_tol=None):
    """Every step's loss; the first step's gradients (``_norm_gap``), the
    parameters after it (absolute) and the buffers (``_norm_gap``); after
    the last step, parameters and buffers within ``last_tol`` of their
    scale (``_norm_gap``) when given."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol)
    for key in ("grads", "params1", "params", "bufs1", "bufs"):
        assert set(got[key]) == set(want[key]), key
    assert _norm_gap(got["grads"], want["grads"]) <= grad_tol
    for k, v in want["params1"].items():
        np.testing.assert_allclose(got["params1"][k], v, rtol=0,
                                   atol=param_atol, err_msg=k)
    assert _norm_gap(got["bufs1"], want["bufs1"]) <= buf_tol
    if last_tol is not None:
        for key in ("params", "bufs"):
            assert _norm_gap(got[key], want[key]) <= last_tol, key


def _norm_gap(got, want):
    """max over tensors of max|got − want| / max(max|want|, 1e-3·G), G the
    largest |value| of all of ``want``: a tensor whose values are all
    near 0 is judged at the scale of the rest."""
    if not want:
        return 0.0
    big = max(np.abs(v).max() for v in want.values())
    return max(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-3 * big)
               for k, v in want.items())


def gaps(got, want):
    """The first step of two records apart: the loss (relative), the
    gradients, the parameters and buffers after it (``_norm_gap``)."""
    return {"loss": abs(got["losses"][0] - want["losses"][0])
            / abs(want["losses"][0]),
            **{k: _norm_gap(got[k], want[k])
               for k in ("grads", "params1", "bufs1")}}


# the floors of the f32 / O1 comparisons: what f32 resolves of a
# well-conditioned step
FLOORS = {"loss": 1e-5, "grads": 1e-4, "params1": 1e-5, "bufs1": 1e-5}
# how many times the reference's own rounding error the port's may be
COND = 4.0


def check_conditioned(apart, yardstick, floors=FLOORS):
    """Each gap of ``apart`` within ``COND`` times the same gap of
    ``yardstick`` (the rounding error of a step in that precision), or
    its floor."""
    for k, v in apart.items():
        assert v <= max(floors[k], COND * yardstick[k]), (k, apart,
                                                          yardstick)


def _data(b, c, hw, seed, classes=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, c, hw, hw).astype(np.float32),
            rs.randint(0, classes, (b,)).astype(np.int32))


# --------------------------------------------------------------------------
# BatchNorm2D in training
# --------------------------------------------------------------------------

def _bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_batch_norm_training_matches_jax(dtype, layout):
    """Three training calls of BatchNorm2D at [2, 5, 2, 2] (B·H·W = 8)
    against JAX ``F.batch_norm(training=True)`` and ``_batch_norm_train``."""
    rs = np.random.RandomState(0)
    c = 5
    w = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    bn = _layers.BatchNorm2D(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    jmean = Tensor(jnp.zeros(c, jnp.float32))
    jvar = Tensor(jnp.ones(c, jnp.float32))
    tdt = getattr(torch, dtype)
    for call in range(3):
        x = (rs.randn(2, c, 2, 2) * 2 + 0.5).astype(np.float32)
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        xt = torch.from_numpy(x).to(tdt)
        if layout == "channels_last":
            xt = xt.contiguous(memory_format=torch.channels_last)
        want, wmean, wvar = (np.asarray(t.data, np.float32) for t in
                             jax_bn_train(xj, jnp.asarray(w), jnp.asarray(b)))
        jout = JF.batch_norm(Tensor(xj), jmean, jvar, Tensor(jnp.asarray(w)),
                             Tensor(jnp.asarray(b)), training=True)
        np.testing.assert_array_equal(np.asarray(jout.data, np.float32), want)
        got, mean, var = _layers.batch_norm_train(xt, bn.weight, bn.bias)
        out = bn(xt)
        assert out.dtype == torch.float32 == got.dtype   # promoted as jnp
        assert str(jout.data.dtype) == "float32"
        torch.testing.assert_close(out, got, rtol=0, atol=0)
        np.testing.assert_allclose(mean.numpy(), wmean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var.numpy(), wvar, rtol=1e-5, atol=1e-6)
        o = out.detach().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(o, want, rtol=1e-5, atol=1e-6)
        else:
            # the normalised value is rounded to bf16 before the affine:
            # one bf16 ulp of it at the channel's scale, times |γ| (and
            # 1e-6 for the f32 affine's own rounding)
            norm = (want - b[:, None, None]) / w[:, None, None]
            ulp = _bf16_ulp(np.abs(norm).max(axis=(0, 2, 3))) * np.abs(w)
            err = np.abs(o - want).max(axis=(0, 2, 3))
            assert (err <= ulp + 1e-6).all(), (err, ulp)
        for buf, ref in ((bn._mean, jmean), (bn._variance, jvar)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(ref.data),
                                       rtol=1e-5, atol=1e-6)
        if call == 0:   # 0.9 · (0, 1) + 0.1 · (mean, biased var)
            np.testing.assert_allclose(
                bn._variance.numpy(),
                0.9 + 0.1 * xt.double().numpy().var(axis=(0, 2, 3)),
                rtol=1e-5)


def test_batch_norm_backward_matches_jax():
    """Gradients of sum(out · r) through BN training, f32."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 2, 2).astype(np.float32)
    r = rs.randn(2, 3, 2, 2).astype(np.float32)
    w = (1 + 0.1 * rs.randn(3)).astype(np.float32)
    b = (0.1 * rs.randn(3)).astype(np.float32)

    def jf(x, w, b):
        return jnp.sum(jax_bn_train(x, w, b)[0].data * r)

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (_layers.batch_norm_train(*ts)[0] * torch.from_numpy(r)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 2, 2), (4, 6, 8, 8)])
def test_batch_norm_backward_bf16_matches_jax(shape):
    """O1's BN: a bf16 input (a conv's output) through BN training and the
    f32 affine, the gradients of sum(out · r) against JAX's: the input's
    in bf16 (the cotangent rounded to bf16 at the rounding point, as the
    JAX cast's transpose does) within one bf16 ulp at each channel's
    scale (measured: bitwise), γ's and β's in f32 within rtol 1e-5
    (measured 5e-7: f32 sums in another order)."""
    rs = np.random.RandomState(9)
    c = shape[1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)

    def jf(x, w, b):
        return jnp.sum(jax_bn_train(x, w, b)[0].data * r)

    want = jax.grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    (_layers.batch_norm_train(xt, wt, bt)[0] * torch.from_numpy(r)).sum(
        ).backward()
    assert xt.grad.dtype == torch.bfloat16 and str(want[0].dtype) == \
        "bfloat16"
    gx = np.asarray(want[0].astype(jnp.float32))
    err = np.abs(xt.grad.float().numpy() - gx).max(axis=(0, 2, 3))
    assert (err <= _bf16_ulp(np.abs(gx).max(axis=(0, 2, 3)))).all(), err
    for t, g in zip((wt, bt), want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_batch_norm_eval_promotes_and_keeps_the_statistics():
    """Eval normalises with the running statistics and leaves them; a
    bf16 input meets the f32 statistics in f32, as ``jnp`` promotes."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 2, 2).astype(
        np.float32))
    bn = _layers.BatchNorm2D(3).eval()
    torch.testing.assert_close(bn(x), x / np.sqrt(1 + 1e-5))
    out = bn(x.bfloat16())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x.bfloat16().float() / np.sqrt(1 + 1e-5))
    assert torch.equal(bn._mean, torch.zeros(3))
    assert torch.equal(bn._variance, torch.ones(3))


# --------------------------------------------------------------------------
# the key stream and dropout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2024, 2 ** 31 - 1])
def test_generator_key_sequence_matches_jax(seed):
    jg, tg = jgen.Generator(seed), Generator(seed)
    for _ in range(6):
        np.testing.assert_array_equal(
            tg.next_key().numpy().astype(np.uint32),
            np.asarray(jg.next_key()))


@pytest.mark.parametrize("p", [0.2, 0.5, 0.7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_bitwise(p, dtype):
    rs = np.random.RandomState(3)
    x = rs.randn(6, 33).astype(np.float32) + 3.0       # no zeros
    g = Generator(11)
    for _ in range(2):
        key = g.next_key()
        jk = jnp.asarray(key.numpy().astype(np.uint32))
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = np.asarray(JF.dropout(Tensor(xj), p, key=jk).data.astype(
            jnp.float32))
        keep = np.asarray(jax.random.bernoulli(jk, 1.0 - p, x.shape))
        got = dropout(torch.from_numpy(x).to(getattr(torch, dtype)), p,
                      key=key)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy()
        np.testing.assert_array_equal(got != 0, keep)
        np.testing.assert_array_equal(got, want)


def test_dropout_module_draws_one_key_a_call_in_training():
    m = _layers.Dropout(0.5)
    x = torch.ones(4, 8)
    assert m.eval()(x) is x
    m.train()
    with pytest.raises(RuntimeError, match="generator"):
        m(x)
    m.generator = Generator(5)
    ref = Generator(5)
    for _ in range(2):
        assert torch.equal(m(x), dropout(x, 0.5, key=ref.next_key()))
    assert _layers.Dropout(0.0).train()(x) is x


# --------------------------------------------------------------------------
# auto_cast
# --------------------------------------------------------------------------

def test_amp_lists_equal_jax():
    assert TAMP.white_list == JAMP.white_list
    assert TAMP.black_list == JAMP.black_list


CUSTOM = [(None, None), (["relu", "mean"], None), (None, ["conv2d"]),
          (["linear"], ["linear", "matmul"]), (["exp"], ["mean"])]


@pytest.mark.parametrize("white,black", CUSTOM)
def test_amp_decisions_equal_jax(white, black):
    names = sorted(JAMP.white_list | JAMP.black_list
                   | {"relu", "batch_norm_train", "add", "max_pool2d"})
    for level in ("O0", "O1", "O2"):
        with pt.amp.auto_cast(True, white, black, level=level):
            want = [JAMP.amp_transform_args(n, None) for n in names]
        with TAMP.auto_cast(True, white, black, level=level):
            got = [TAMP.amp_transform_args(n) for n in names]
        want = [None if d is None else str(jnp.dtype(d)) for d in want]
        got = [None if d is None else str(d).replace("torch.", "")
               for d in got]
        assert got == want, level
    assert TAMP.amp_transform_args("conv2d") is None      # outside: off


def _layer_dtypes_jax(model, x, amp_kw):
    seen = {}
    hooks = [layer.register_forward_post_hook(
        lambda _l, _i, out, name=name: seen.__setitem__(
            name, str(out._data.dtype)))
        for name, layer in model.named_sublayers()]
    with _tape.no_grad(), jax_o1(), pt.amp.auto_cast(True, **amp_kw):
        model(Tensor(jnp.asarray(x)))
    for h in hooks:
        h.remove()
    return seen


def _layer_dtypes_port(model, x, amp_kw):
    seen = {}
    hooks = [mod.register_forward_hook(
        lambda _m, _i, out, name=name: seen.__setitem__(
            name, str(out.dtype).replace("torch.", "")))
        for name, mod in model.named_modules() if name]
    with torch.no_grad(), TAMP.auto_cast(True, **amp_kw):
        model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return seen


@pytest.fixture(scope="module")
def resnet18_pair():
    pt.seed(0)
    jm = JM.resnet18(num_classes=10)
    return jm, port_of(jm, "resnet18", {"num_classes": 10})


@pytest.mark.parametrize("amp_kw", [{}, {"custom_black_list": ["linear"]},
                                    {"custom_black_list": ["conv2d"]}],
                         ids=["o1", "black-linear", "black-conv2d"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_o1_layer_dtypes_equal_jax(resnet18_pair, amp_kw, mode):
    """The dtype every named sublayer of ResNet-18 returns under O1 (conv
    bf16, BN f32 after its rounding, relu / pool / add f32, fc bf16)."""
    jm, tm = resnet18_pair
    getattr(jm, mode)()
    getattr(tm, mode)()
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    want = _layer_dtypes_jax(jm, x, amp_kw)
    got = _layer_dtypes_port(tm, x, amp_kw)
    jm.train()
    assert got == want
    assert "bfloat16" in got.values() and "float32" in got.values()


def test_amp_reductions_and_cross_entropy_run_in_f32():
    """``cross_entropy`` (black list) reduces bf16 logits in f32 under O1,
    its gradient reaching the logits in their bf16; outside ``auto_cast``
    it keeps their dtype; ``Linear`` (white list) runs in bf16."""
    x = torch.randn(4, 10).bfloat16().requires_grad_()
    y = torch.tensor([1, 2, 3, 4])
    with TAMP.auto_cast(True):
        loss = cross_entropy(x, y)
        assert loss.dtype == torch.float32
        for red in ("sum", "none"):
            assert cross_entropy(x, y, reduction=red).dtype == torch.float32
        lin = _layers.Linear(10, 3)
        assert lin(torch.randn(2, 10)).dtype == torch.bfloat16
    loss.backward()
    assert x.grad.dtype == torch.bfloat16
    with TAMP.auto_cast(False):
        assert cross_entropy(x, y).dtype == torch.bfloat16


def _jax_layer_grads(layer, params, x, rs):
    """The JAX layer's bf16 output ``out`` under ``jax_o1``, a cotangent
    ``r`` drawn from ``rs``, and the gradients of sum(out · r) in its f32
    input and parameters."""
    def fwd(parrs, xarr):
        with _bind(params, parrs), _tape.no_grad(), jax_o1():
            return layer(Tensor(xarr)).data

    parrs = [p._data for p in params]
    out = fwd(parrs, jnp.asarray(x))
    r = rs.randn(*out.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xa: jnp.sum(
        fwd(p, xa).astype(jnp.float32) * r), argnums=(0, 1))(
        parrs, jnp.asarray(x))
    return out, r, [gx] + list(gp)


O1_LAYERS = {
    "conv": (lambda: pt.nn.Conv2D(32, 16, 3, padding=1, bias_attr=False),
             lambda: _layers.conv(32, 16, 3, 1, 1), (4, 32, 12, 12)),
    "conv-bias": (lambda: pt.nn.Conv2D(6, 8, 3, padding=1),
                  lambda: _layers.conv(6, 8, 3, 1, 1, bias=True),
                  (4, 6, 8, 8)),
    "linear": (lambda: pt.nn.Linear(24, 10), lambda: _layers.Linear(24, 10),
               (5, 24)),
}


@pytest.mark.parametrize("name", sorted(O1_LAYERS))
def test_o1_cast_layers_backward_match_jax(name):
    """O1's white-list layers (bf16 compute from f32 input and
    parameters) forward and backward against the JAX layers under
    ``jax_o1``, on an f32 input and a nonzero bias: the bf16 output, and
    the gradients of the input, the weight and the bias, which reach
    them in f32 through the cast. Bounds in bf16 ulps at the tensor's
    scale: the output within 1 (a rare sum order flips a rounding;
    with a bias JAX rounds the product before the bias is added and the
    port after, measured 1), the input's and weight's gradients within 1
    (measured ≤ 0.5). The bias's gradient is the sum of the bf16
    cotangent over the rows, rounded to bf16: the port's within 1 ulp of
    that sum taken in f64, and within 1 ulp more than JAX's own distance
    from it (XLA's CPU sums in bf16: 6 ulps off at 256 rows)."""
    jmake, tmake, xshape = O1_LAYERS[name]
    pt.seed(0)
    jl, tl = jmake(), tmake()
    rs = np.random.RandomState(7)
    params = [p for p in (jl.weight, jl.bias) if p is not None]
    if jl.bias is not None:
        jl.bias._data = jnp.asarray(0.1 * rs.randn(*jl.bias.shape),
                                    jnp.float32)
    with torch.no_grad():
        for p, tp in zip(params, (tl.weight, tl.bias)):
            tp.copy_(torch.from_numpy(np.array(p._data)))
    x = rs.randn(*xshape).astype(np.float32)
    out, r, want = _jax_layer_grads(jl, params, x, rs)
    xt = torch.from_numpy(x).requires_grad_()
    with TAMP.auto_cast(True):
        got = tl(xt)
    assert got.dtype == torch.bfloat16 and str(out.dtype) == "bfloat16"
    (got.float() * torch.from_numpy(r)).sum().backward()
    grads = [xt.grad] + [t.grad for t in (tl.weight, tl.bias)
                         if t is not None]
    for g, w in zip([got.detach()] + grads[:2], [out] + want[:2]):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape
        err = np.abs(g.float().numpy() - w).max()
        assert err <= _bf16_ulp(np.abs(w).max()), err
    if len(grads) == 3:
        rows = tuple(i for i in range(r.ndim) if i != 1)
        exact = torch.from_numpy(r).bfloat16().double().sum(rows).numpy()
        g = grads[2].numpy()
        w = np.asarray(want[2].astype(jnp.float32))
        ulp = _bf16_ulp(np.abs(exact).max())
        assert np.abs(g - exact).max() <= ulp
        assert (np.abs(g - w) <= np.abs(w - exact) + ulp).all()


# --------------------------------------------------------------------------
# cross_entropy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_cross_entropy_matches_jax(reduction, ignore_index):
    rs = np.random.RandomState(5)
    logits = rs.randn(7, 10).astype(np.float32) * 3
    labels = rs.randint(0, 10, (7,)).astype(np.int32)
    labels[[1, 4]] = ignore_index
    kw = dict(ignore_index=ignore_index, reduction=reduction)

    def jf(z):
        return JF.cross_entropy(z, jnp.asarray(labels), **kw).data

    want = np.asarray(jf(jnp.asarray(logits)))
    wgrad = np.asarray(jax.grad(lambda z: jnp.sum(jf(z)))(
        jnp.asarray(logits)))
    z = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy(z, torch.from_numpy(labels), **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(z.grad.numpy(), wgrad, rtol=1e-5, atol=1e-7)


def test_cross_entropy_all_rows_ignored_is_zero():
    loss = cross_entropy(torch.randn(3, 4), torch.full((3,), -100))
    assert float(loss) == 0.0


# --------------------------------------------------------------------------
# Momentum
# --------------------------------------------------------------------------

def _grads(rs, shapes):
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _optax_sgd(init, grads, jit):
    opt = optax.sgd(LR, momentum=MOM)
    params = [jnp.asarray(p) for p in init]
    state = opt.init(params)

    def one(g, s, p):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    one = jax.jit(one) if jit else one
    for g in grads:
        params, state = one([jnp.asarray(a) for a in g], state, params)
    return [np.asarray(p) for p in params]


def test_momentum_matches_optax_and_jax_momentum_bitwise():
    """Three updates: bitwise against ``pt.optimizer.Momentum`` and against
    ``optax.sgd`` run op by op; against the jitted ``optax.sgd`` within
    four f32 ulps at the parameters' scale: XLA's CPU backend contracts
    ``g + 0.9·trace`` or ``p + (−lr·trace)`` into a fused multiply-add
    (one rounding, not two), and the difference carries over the steps
    (cancellation leaves some elements a few ulps of their own size
    apart)."""
    rs = np.random.RandomState(6)
    shapes = [(5, 3, 3, 3), (7,), (11, 4)]
    init = _grads(rs, shapes)
    grads = [_grads(rs, shapes) for _ in range(3)]
    eager = _optax_sgd(init, grads, jit=False)
    jitted = _optax_sgd(init, grads, jit=True)
    jparams = [pt.create_parameter(p.shape, "float32") for p in init]
    for jp, p in zip(jparams, init):
        jp._data = jnp.asarray(p)
    jopt = pt.optimizer.Momentum(LR, MOM, parameters=jparams)
    tparams = [torch.from_numpy(p.copy()).requires_grad_() for p in init]
    topt = Momentum(LR, MOM, tparams)
    for g in grads:
        for jp, a in zip(jparams, g):
            jp._grad = Tensor(jnp.asarray(a))
        jopt.step()
        for tp, a in zip(tparams, g):
            tp.grad = torch.from_numpy(a.copy())
        topt.step()
        assert all(tp.grad is not None for tp in tparams)
        topt.clear_grad()
        assert all(tp.grad is None for tp in tparams)
    for tp, e, j, jp in zip(tparams, eager, jitted, jparams):
        got = tp.detach().numpy()
        np.testing.assert_array_equal(got, e)
        np.testing.assert_array_equal(got, np.asarray(jp._data))
        scale = np.abs(j).max()
        np.testing.assert_allclose(got, j, rtol=0,
                                   atol=4 * np.spacing(np.float32(scale)))


# --------------------------------------------------------------------------
# the train step: ResNet-18 / ResNet-50
# --------------------------------------------------------------------------

RESNETS = ("resnet18", "resnet50")


@pytest.fixture(scope="module", params=RESNETS)
def resnet_ref(request):
    """The JAX model's state, a batch, and the JAX step's records: 3 f64
    steps, 1 f32 step, 1 O1 step."""
    name = request.param
    pt.seed(0)
    jm = getattr(JM, name)(num_classes=10)
    x, y = _data(4, 3, 32, 8)
    state = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    return dict(name=name, state=state, x=x, y=y,
                f64=JaxStep(jm).run(x, y, 3, dtype=np.float64),
                f32=JaxStep(jm).run(x, y, 1),
                o1=JaxStep(jm, amp=True).run(x, y, 1))


def _port_resnet(ref):
    port = getattr(TM, ref["name"])(num_classes=10, device="cpu")
    port.load_state_dict(TM.params_from_jax(ref["state"], device="cpu"))
    return port


@pytest.fixture(scope="module")
def resnet_port64(resnet_ref):
    return port_run(_port_resnet(resnet_ref), resnet_ref["x"],
                    resnet_ref["y"], 3, dtype=torch.float64)


def test_resnet_train_step_f64_matches_jax(resnet_ref, resnet_port64):
    """The step's arithmetic: 3 steps in f64 on both sides (the cross
    entropy's statistics are f32 on both). Every loss rtol 1e-5; step 1:
    gradients within 1e-5 of their scale (measured 1e-7), parameters
    atol 3e-5, buffers within 1e-5. At lr 0.1 on 4 images the step
    diverges (the loss goes 3.4 → 9.0 → 7.8 / 46, weights grow to 1e2-1e3
    by step 3) and the f32 cross entropy's last-bit differences grow with
    it: after step 3 the parameters and buffers are held within 5e-4 of
    their scale (measured 3.5e-5 / 4.6e-5 for ResNet-18 / -50)."""
    check_step(resnet_port64, resnet_ref["f64"], last_tol=5e-4)


def test_resnet_train_step_f32_is_as_accurate_as_jax(resnet_ref,
                                                     resnet_port64):
    """One f32 step: its distance from the f64 step (loss, gradients,
    parameters, buffers) within ``COND`` times the JAX f32 step's (or
    the floor). At B 4 and 32² the deep BNs normalise over 4 to 16
    values a channel: f32 resolves ResNet-50's step to ~8e-2 of the
    gradient scale (JAX 8.2e-2, the port 6.1e-2; ResNet-18 2.3e-4 and
    1.8e-4), so two f32 steps cannot agree more closely."""
    got = port_run(_port_resnet(resnet_ref), resnet_ref["x"],
                   resnet_ref["y"], 1)
    check_conditioned(gaps(got, resnet_ref["f64"]),
                      gaps(resnet_ref["f32"], resnet_ref["f64"]))


# The O1 step against the JAX O1 step where its loss is conditioned:
# ResNet-18 at B 8, 64², ResNet-50 at B 16, 128² (at B 4, 32² bf16 moves
# the loss by 4e-2 to 1e-1 on both sides; ResNet-50 at B 8 by 4.6e-2).
O1_SIZES = {"resnet18": (8, 64), "resnet50": (16, 128)}


@pytest.fixture(scope="module")
def resnet_o1(resnet_ref):
    """One O1 step at ``O1_SIZES``, 10 classes: the JAX step's record, the
    port's, and the parameters both start from."""
    name = resnet_ref["name"]
    b, hw = O1_SIZES[name]
    pt.seed(0)
    jm = getattr(JM, name)(num_classes=10)
    x, y = _data(b, 3, hw, 8)
    p0 = {n: np.asarray(p._data, np.float64)
          for n, p in jm.named_parameters()}
    port = port_of(jm, name, {"num_classes": 10})
    return dict(name=name, jax=JaxStep(jm, amp=True).run(x, y, 1),
                port=port_run(port, x, y, 1, amp=True), p0=p0)


def test_resnet_train_step_o1_is_as_accurate_as_jax(resnet_ref, resnet_o1):
    """One O1 step (bf16 convs and fc, f32 BN statistics, loss and
    update) against the f64 step, within ``COND`` times the JAX O1
    step's distance (``jax_o1``); at ``O1_SIZES`` the two O1 losses
    within ``BF16_LOSS_REL`` (measured 2.1e-3 / 1.4e-3). At B 4, 32² bf16
    moves the loss by 4e-2 to 1e-1 and the gradients by their own scale,
    on both sides (JAX 3.7 / 1.5 of the gradient scale, the port 1.5 /
    4.5, ResNet-18 / -50), so the gradients are held by
    ``test_resnet_o1_step_agrees_with_jax_o1``."""
    got = port_run(_port_resnet(resnet_ref), resnet_ref["x"],
                   resnet_ref["y"], 1, amp=True)
    check_conditioned(gaps(got, resnet_ref["f64"]),
                      gaps(resnet_ref["o1"], resnet_ref["f64"]))
    want = resnet_o1["jax"]["losses"][0]
    rel = abs(resnet_o1["port"]["losses"][0] - want) / want
    assert rel <= BF16_LOSS_REL, rel


# The O1 step's gradients against the JAX O1 step's (``resnet_o1``). A
# BN network's backward at random init amplifies a rounding difference
# layer by layer toward the input (ResNet-18 f32 vs f64: 1e-3 of the
# gradients' norm; JAX's O1 vs its f32 step: 0.31, the port's O1 vs
# JAX's 0.36, 3 % at the fc and 40 % at the stem), so the gradients are
# held in direction and size, which bf16's rounding moves little: the
# cosine of all of them as one vector and the least over the tensors
# (measured 0.939 / 0.903; JAX O1 vs its f32 0.952 / 0.905), the ratio
# of their norms, all and per tensor (measured 1.000; 0.971 .. 1.075). A
# zeroed, halved or sign-flipped gradient, of all or of one tensor,
# fails. ResNet-50's deeper gradients part under bf16 on both sides
# (cosine 0.15 to JAX's; JAX's own O1 vs f32 0.22 at B 8, 64²; 0.14 on
# the card at B 128, ``chip_smoke.py`` phase 19 (a)): it is held by the
# ratio of all of them (measured 0.986) and by the head, the fc, in
# direction and size (both models; measured cosine 0.9995 / 0.9924,
# ratio 0.998 / 0.990).
O1_COS, O1_TENSOR_COS = 0.85, 0.75
O1_RATIO, O1_TENSOR_RATIO = (0.9, 1.1), (0.75, 1.33)
O1_HEAD_COS, O1_HEAD_RATIO = 0.95, (0.9, 1.1)
HEAD = ("fc.weight", "fc.bias")


def _agreement(got, want):
    """The cosine of ``got`` and ``want`` (by name) as one vector, the
    ratio of their norms, and over the tensors the least cosine and the
    least and largest norm ratio."""
    dots = {k: float((got[k] * v).sum()) for k, v in want.items()}
    gg = {k: float((got[k] ** 2).sum()) for k in want}
    ww = {k: float((v ** 2).sum()) for k, v in want.items()}
    cos = [dots[k] / max(np.sqrt(gg[k] * ww[k]), 1e-300) for k in want
           if ww[k] > 0]
    ratio = [np.sqrt(gg[k] / ww[k]) for k in want if ww[k] > 0]
    return dict(cos=sum(dots.values()) / max(
        np.sqrt(sum(gg.values()) * sum(ww.values())), 1e-300),
        ratio=np.sqrt(sum(gg.values()) / sum(ww.values())),
        tensor_cos_min=min(cos), tensor_ratio_min=min(ratio),
        tensor_ratio_max=max(ratio))


def _agrees(got, want, name):
    """``got`` agrees with ``want`` in direction and size (above)."""
    a = _agreement(got, want)
    h = _agreement({k: got[k] for k in HEAD}, {k: want[k] for k in HEAD})
    ok = (O1_RATIO[0] <= a["ratio"] <= O1_RATIO[1]
          and h["cos"] >= O1_HEAD_COS
          and O1_HEAD_RATIO[0] <= h["ratio"] <= O1_HEAD_RATIO[1])
    if name == "resnet18":
        ok = ok and (a["cos"] >= O1_COS
                     and a["tensor_cos_min"] >= O1_TENSOR_COS
                     and a["tensor_ratio_min"] >= O1_TENSOR_RATIO[0]
                     and a["tensor_ratio_max"] <= O1_TENSOR_RATIO[1])
    return ok


def test_resnet_o1_step_agrees_with_jax_o1(resnet_o1):
    """The O1 step (bf16 convs and fc, BN's rounding point and f32
    statistics, f32 loss and update) against JAX's, from one state: the
    gradients and the update after the step (−lr · g at the first step)
    in direction and size (``_agrees``); the BN buffers after the step
    (the forward's statistics of bf16 conv outputs) within 0.05 / 0.15
    of their scale (measured 0.012 / 0.049). The bounds see a wrong
    gradient: zeroed, halved or sign-flipped, of all tensors or of the
    fc's weight alone."""
    name, want, got, p0 = (resnet_o1[k] for k in ("name", "jax", "port",
                                                  "p0"))
    g, w = got["grads"], want["grads"]
    assert _agrees(g, w, name), (_agreement(g, w), _agreement(
        {k: g[k] for k in HEAD}, {k: w[k] for k in HEAD}))

    def update(rec):
        return {k: rec["params1"][k] - v for k, v in p0.items()}

    assert _agrees(update(got), update(want), name)
    assert _norm_gap(got["bufs1"], want["bufs1"]) <= (
        0.05 if name == "resnet18" else 0.15)
    for f in (0.0, 0.5, -1.0):
        assert not _agrees({k: f * v for k, v in g.items()}, w, name)
        assert not _agrees(dict(g, **{"fc.weight": f * g["fc.weight"]}), w,
                           name)


def test_resnet_train_step_keeps_state_in_place(resnet_ref):
    """The step updates the model's own tensors, in place, and returns
    each step's loss as a 0-d f32 tensor, finite."""
    port = _port_resnet(resnet_ref)
    ptrs = {n: p.data_ptr() for n, p in port.state_dict().items()}
    step = TT.make_train_step(port, device="cpu")
    x = torch.from_numpy(resnet_ref["x"])
    y = torch.from_numpy(resnet_ref["y"]).long()
    losses = [step(x, y) for _ in range(3)]
    assert all(v.shape == () and v.dtype == torch.float32 for v in losses)
    assert all(torch.isfinite(v) for v in losses)
    assert {n: p.data_ptr() for n, p in port.state_dict().items()} == ptrs
    opt = step.optimizer
    vel = opt._accumulators["velocity"][id(opt._param_list[0])]
    assert vel.data_ptr() != ptrs["conv1.weight"]


# --------------------------------------------------------------------------
# GoogLeNet's auxiliary heads (the zoo's train steps:
# test_torch_vision_train_zoo.py)
# --------------------------------------------------------------------------

def test_googlenet_aux_heads_in_training_and_eval():
    model = TM.googlenet(num_classes=7, device="cpu")
    for m in model.modules():
        if isinstance(m, _layers.Dropout):
            m.generator = Generator(0)
    out, aux1, aux2 = model.train()(torch.zeros(1, 3, 64, 64))
    assert out.shape == aux1.shape == aux2.shape == (1, 7)
    with torch.no_grad():
        _, aux1, aux2 = model.eval()(torch.zeros(1, 3, 64, 64))
    assert aux1 is None and aux2 is None


# --------------------------------------------------------------------------
# the train-time transforms
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train_counts():
    rules = default_rewrites(("conv-bn-fold", "stem-space-to-depth",
                              "conv-nhwc-layout"))
    return count_matches(resnet_rewrite_targets(18, 64, 2)[1].jaxpr, rules)


def test_prepare_training_fires_where_the_jax_passes_fire(jax_train_counts):
    model = TM.resnet18(num_classes=10, device="cpu")
    _, fired = prepare_training(model)
    assert fired == jax_train_counts == {"stem-space-to-depth": 1,
                                         "conv-nhwc-layout": 19}
    _, fired = prepare_training(TM.resnet50(num_classes=10, device="cpu"))
    assert fired == {"stem-space-to-depth": 1, "conv-nhwc-layout": 52}


@pytest.mark.parametrize("name", RESNETS)
def test_prepare_training_keeps_the_step(name):
    """The transformed model against the untransformed one from one
    state: the forward in f32 (eval: logits within 1e-5 of their scale),
    and one train step in f64 (loss, gradients, updated parameters and
    buffers within 1e-6, the cross entropy's statistics being f32: the
    same taps summed in another order; in f32
    the train-mode BNs over 4 values a channel at this batch would
    amplify that reordering to O(1), as the deep BNs do the rounding in
    ``test_resnet_train_step_f32_is_as_accurate_as_jax``). The
    parameters stay the same objects and
    the ``state_dict`` keys the same, the stem's weight gets its gradient
    through the space-to-depth route, and the fold still refuses the
    model."""
    gen = torch.Generator().manual_seed(3)
    base = getattr(TM, name)(num_classes=10, device="cpu", generator=gen)
    other = getattr(TM, name)(num_classes=10, device="cpu")
    other.load_state_dict(base.state_dict())
    params = {n: p for n, p in other.named_parameters()}
    keys = list(other.state_dict())
    prepared, _ = prepare_training(other)
    assert prepared is other and list(other.state_dict()) == keys
    assert all(p is params[n] for n, p in other.named_parameters())
    assert other.conv1.stem_s2d and other.layer1[0].conv1.weight.\
        is_contiguous(memory_format=torch.channels_last)
    x, y = _data(4, 3, 32, 10)
    with torch.no_grad():
        want = base.eval()(torch.from_numpy(x))
        got = other.eval()(torch.from_numpy(x))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    want = port_run(base, x, y, 1, dtype=torch.float64)
    got = port_run(other, x, y, 1, dtype=torch.float64)
    check_step(got, want, grad_tol=1e-6, param_atol=1e-6, buf_tol=1e-6,
               loss_rtol=1e-6)
    assert np.abs(got["grads"]["conv1.weight"]).max() > 0
    with pytest.raises(ValueError, match="eval"):
        fold_conv_bn(other)


@pytest.mark.parametrize("bias", [False, True])
def test_stem_route_keeps_the_jax_contract(bias):
    """The stem conv on the space-to-depth route against the plain conv:
    f32 within 1e-5 (the JAX pass measures ~1e-7), bf16 under O1 within
    the pass's contract (rtol 5e-2, atol 2e-2); an odd image takes the
    plain conv; the gradients of x and of the weight agree."""
    gen = torch.Generator().manual_seed(4)
    conv = _layers.conv(3, 8, 7, 2, 3, bias=bias)
    s2d = _layers.conv(3, 8, 7, 2, 3, bias=bias)
    s2d.load_state_dict(conv.state_dict())
    s2d.stem_s2d = True
    for hw in (16, 15):
        x = torch.randn(2, 3, hw, hw, generator=gen)
        torch.testing.assert_close(s2d(x), conv(x), rtol=1e-5, atol=1e-5)
        with TAMP.auto_cast(True):
            a, b = s2d(x), conv(x)
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=5e-2,
                                   atol=2e-2)
    x = torch.randn(2, 3, 16, 16, generator=gen, requires_grad=True)
    g = torch.randn(2, 8, 8, 8, generator=gen)
    grads = []
    for m in (s2d, conv):
        m.weight.grad = None
        (m(x) * g).sum().backward()
        grads.append((x.grad.clone(), m.weight.grad.clone()))
        x.grad = None
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
