"""The port's ResNet and its conv-bn fold vs the JAX package's: the eval
forward unfolded, and folded (``analysis.fold_conv_bn``) against the JAX
forward rewritten by ``ConvBnFoldPass`` with its Pallas route, for
``resnet18``, ``resnet50`` and ``resnext50_32x4d`` (B 2, image 32, 10
classes).

The JAX model is built with its own init; its BN statistics and affine
are then set from numpy with a seed (far from the init's identity fold),
and its ``state_dict`` goes to the port through ``params_from_jax``. The
rewritten JAX forward runs as the JAX package's own tests run it
(``rewrite_callable(fwd, rules=("conv-bn-fold",))``) with
``PADDLE_TPU_CONV_EPILOGUE_IMPL=pallas``, the kernel in interpret mode,
under the default matmul precision: the rewrite keeps a conv's precision
request, and takes the Pallas route only for the default one.

Contract: logits within 1e-4 × the largest |logit| (f32 sums of 53 convs
taken in another order, the fold's reassociation on top), top-1 equal;
the fold fires where the JAX pass fires; ``params_from_jax`` bitwise."""
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.analysis.framework import default_rewrites
from paddle_tpu.analysis.rewrite import rewrite_callable, rewrite_jaxpr
from paddle_tpu.autograd import tape as _tape
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import resnet as JR
from paddle_tpu.static.nn import _bind
from paddle_tpu_torch.analysis import ConvBnAct, fold_conv_bn
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.ops.kernels import conv_epilogue as TK

MODELS = ("resnet18", "resnet50", "resnext50_32x4d")
# sites of the fold, and of them the 1x1 / stride-1 ones (the kernel's)
FOLD_SITES = {"resnet18": 20, "resnet50": 53, "resnext50_32x4d": 53}
ROWWISE_SITES = {"resnet18": 0, "resnet50": 33, "resnext50_32x4d": 33}
LOGIT_REL = 1e-4
RULES = ("conv-bn-fold",)


def seed_bn_stats(model, rs):
    """Means N(0, 0.1), variances U(0.5, 1.5), γ ≈ 1 and β ≈ 0 with
    noise, on every BatchNorm2D of the JAX model."""
    for layer in model.sublayers():
        if isinstance(layer, pt.nn.BatchNorm2D):
            c = layer.num_features
            layer._mean._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)
            layer._variance._data = jnp.asarray(rs.uniform(0.5, 1.5, c),
                                                jnp.float32)
            layer.weight._data = jnp.asarray(1 + 0.1 * rs.randn(c),
                                             jnp.float32)
            layer.bias._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)


@pytest.fixture(scope="module", params=MODELS)
def ref(request):
    """The JAX model's state (numpy), an input, and its logits: eval
    forward, and the conv-bn-fold rewrite with the Pallas route."""
    name = request.param
    pt.seed(0)
    model = getattr(JR, name)(num_classes=10)
    seed_bn_stats(model, np.random.RandomState(1))
    model.eval()
    params = model.parameters()
    bufs = list(model.buffers())
    parrs = [p._data for p in params]
    barrs = [b._data for b in bufs]

    def fwd(parrs, barrs, x):
        with _bind(params, parrs), _bind(bufs, barrs), _tape.no_grad():
            return model(Tensor(x)).data

    x = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    eager = np.array(jax.jit(fwd)(parrs, barrs, x))
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("default"):
        mp.setenv("PADDLE_TPU_CONV_EPILOGUE_IMPL", "pallas")
        fired = rewrite_jaxpr(jax.make_jaxpr(fwd)(parrs, barrs, x),
                              default_rewrites(RULES)).fired
        folded = np.array(jax.jit(rewrite_callable(fwd, rules=RULES))(
            parrs, barrs, x))
    state = {k: np.array(v._data) for k, v in model.state_dict().items()}
    return dict(name=name, state=state, x=x, eager=eager, folded=folded,
                fired=fired)


def port_model(ref):
    model = getattr(TR, ref["name"])(num_classes=10, device="cpu")
    model.load_state_dict(TR.params_from_jax(ref["state"], device="cpu"))
    return model.eval()


def check_logits(got, want):
    got = got.detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_REL * scale, \
        (np.abs(got - want).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_params_from_jax_round_trips_bitwise(ref):
    state = TR.params_from_jax(ref["state"], device="cpu")
    model = port_model(ref)
    assert set(model.state_dict()) == set(ref["state"])
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), ref["state"][k], err_msg=k)
        assert torch.equal(state[k], v)


def test_unfolded_forward_matches_jax(ref):
    with torch.no_grad():
        check_logits(port_model(ref)(torch.from_numpy(ref["x"])),
                     ref["eager"])


def test_folded_forward_matches_jax_rewrite(ref):
    folded, _ = fold_conv_bn(port_model(ref))
    with torch.no_grad():
        check_logits(folded(torch.from_numpy(ref["x"])), ref["folded"])


def test_fold_fires_where_the_jax_pass_fires(ref):
    _, fired = fold_conv_bn(port_model(ref))
    assert fired == {"conv-bn-fold": FOLD_SITES[ref["name"]]}
    assert ref["fired"] == fired


def test_rowwise_sites_reach_the_kernel_entry(ref, monkeypatch):
    """Every 1x1 / stride-1 site calls ``matmul_bias_act`` once a forward
    (the plain version here: the tensors are on the CPU), on a view of a
    channels-last activation."""
    calls = []
    real = TK.matmul_bias_act

    def spy(x2, w, bias, relu=True, impl="auto"):
        calls.append((tuple(x2.shape), relu))
        return real(x2, w, bias, relu=relu, impl=impl)

    monkeypatch.setattr(TK, "matmul_bias_act", spy)
    folded, _ = fold_conv_bn(port_model(ref))
    copies = real.input_copies
    launches = real.launches
    with torch.no_grad():
        folded(torch.from_numpy(ref["x"]))
    assert len(calls) == ROWWISE_SITES[ref["name"]]
    assert real.input_copies == copies
    assert real.launches == launches
    # relu on the 16 bottlenecks' conv1, not on conv3 or the downsample
    assert sum(r for _, r in calls) == (16 if calls else 0)


def test_fold_refuses_a_training_model():
    model = TR.resnet18(num_classes=10, device="cpu")
    with pytest.raises(ValueError, match="eval"):
        fold_conv_bn(model)
    model.eval()
    model.layer1[0].bn1.train()
    with pytest.raises(ValueError, match="batch"):
        fold_conv_bn(model)
    # the one BN in training normalises with the batch's statistics and
    # moves its running ones (0.9 · old + 0.1 · batch; the batch is 0s)
    with torch.no_grad():
        assert torch.isfinite(model(torch.zeros(1, 3, 32, 32))).all()
    bn = model.layer1[0].bn1
    assert torch.equal(bn._mean, torch.zeros_like(bn._mean))
    torch.testing.assert_close(bn._variance, torch.full_like(bn._variance,
                                                             0.9))


def test_fold_in_bfloat16_folds_every_site():
    """A bf16 model (BN buffers bf16 too, as ``Layer.bfloat16()`` leaves
    the JAX one) folds at every site; weights bf16, biases f32."""
    model = TR.resnet50(num_classes=10, device="cpu",
                        dtype=torch.bfloat16).eval()
    folded, fired = fold_conv_bn(model)
    assert fired == {"conv-bn-fold": 53}
    sites = [m for m in folded.modules() if isinstance(m, ConvBnAct)]
    assert len(sites) == 53 and sum(m.rowwise for m in sites) == 33
    assert all(m.weight.dtype == torch.bfloat16 and
               m.bias.dtype == torch.float32 for m in sites)
    with torch.no_grad():
        out = folded(torch.zeros(1, 3, 32, 32, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
