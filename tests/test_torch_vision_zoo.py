"""The port's vision zoo and its conv-bn fold vs the JAX package's: for each
family (LeNet, AlexNet, VGG with and without BN, SqueezeNet 1.0 / 1.1,
MobileNet V1 / V2 / V3 Small / V3 Large, ShuffleNetV2 × 0.25 / × 1.0 /
swish, DenseNet-121, GoogLeNet, Inception v3) at the JAX package's own
zoo-test sizes (``tests/test_vision_zoo.py``: 32², 64² or 75², LeNet at
28², B 2, 10 classes, ``scale`` 0.25-0.5 where the factory takes it),
the eval forward unfolded, and folded (``analysis.fold_conv_bn``)
against the JAX forward rewritten by ``ConvBnFoldPass`` with its Pallas
route in interpret mode.

The JAX model is built with its own init; its BN statistics and affine
and its conv biases are then set from numpy with a seed, and its
``state_dict`` goes to the port through ``params_from_jax``. The
rewritten JAX forward runs as ``tests/test_torch_resnet.py`` runs it.

Contract: logits within 1e-4 × the largest |logit| (f32 sums in other
orders, the fold's reassociation on top), top-1 equal; the fold fires
where the JAX pass fires; its sites by route (``site_routes``: the
1x1 sites on the conv-epilogue kernel, ShuffleNetV2's 1x1 sites whose
widths are not multiples of 8 routed onto the conv route) and the
row-wise inputs it copies are pinned; ``params_from_jax`` bitwise."""
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.analysis.framework import default_rewrites
from paddle_tpu.analysis.rewrite import rewrite_jaxpr
from paddle_tpu.autograd import tape as _tape
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.static.nn import _bind
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.analysis import ConvBnAct, fold_conv_bn, site_routes
from paddle_tpu_torch.ops.kernels import conv_epilogue as TK
from paddle_tpu_torch.vision import models as TM

LOGIT_REL = 1e-4
RULES = ("conv-bn-fold",)

# name: (factory, kwargs, image size, input channels)
ZOO = {
    "lenet": ("LeNet", {}, 28, 1),
    "alexnet": ("alexnet", {}, 64, 3),
    "vgg11": ("vgg11", {}, 32, 3),
    "vgg11_bn": ("vgg11", {"batch_norm": True}, 32, 3),
    "squeezenet1_0": ("squeezenet1_0", {}, 64, 3),
    "squeezenet1_1": ("squeezenet1_1", {}, 64, 3),
    "mobilenet_v1": ("mobilenet_v1", {"scale": 0.25}, 32, 3),
    "mobilenet_v2": ("mobilenet_v2", {"scale": 0.25}, 32, 3),
    "mobilenet_v3_small": ("mobilenet_v3_small", {"scale": 0.5}, 32, 3),
    "mobilenet_v3_large": ("mobilenet_v3_large", {"scale": 0.5}, 32, 3),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", {}, 32, 3),
    "shufflenet_v2_x1_0": ("shufflenet_v2_x1_0", {}, 32, 3),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", {}, 32, 3),
    "densenet121": ("densenet121", {}, 32, 3),
    "googlenet": ("googlenet", {}, 64, 3),
    "inception_v3": ("inception_v3", {}, 75, 3),
}
# the fold's sites by route. No site in the models whose convs all carry
# a bias (LeNet, AlexNet, VGG even with BN, SqueezeNet, GoogLeNet); every
# ConvBNReLU / BasicConv2D and projection in the others. ShuffleNetV2:
# × 0.25's stage-1 branches are 12 wide (9 1x1 sites routed); × 1.0's
# stages 1 and 2 are 58 and 116 wide (26 routed), only stage 3 (232) and
# conv_last reach the kernel.
ROUTES = {
    "mobilenet_v1": {"conv": 14, "kernel": 13},
    "mobilenet_v2": {"conv": 18, "kernel": 34},
    "mobilenet_v3_small": {"conv": 12, "kernel": 22},
    "mobilenet_v3_large": {"conv": 16, "kernel": 30},
    "shufflenet_v2_x0_25": {"conv": 20, "routed": 9, "kernel": 27},
    "shufflenet_v2_x1_0": {"conv": 20, "routed": 26, "kernel": 10},
    "shufflenet_v2_swish": {"conv": 20, "routed": 26, "kernel": 10},
    "densenet121": {"stem": 1, "kernel": 58},
    "inception_v3": {"conv": 54, "kernel": 40},
}
# kernel sites folded with their relu (the rest carry ReLU6, hardswish,
# swish or nothing after them, as separate ops)
RELU_SITES = {"mobilenet_v1": 13, "mobilenet_v3_small": 2,
              "mobilenet_v3_large": 5, "shufflenet_v2_x0_25": 27,
              "shufflenet_v2_x1_0": 10, "densenet121": 58,
              "inception_v3": 40}
# row-wise inputs copied a forward: a ShuffleUnit's second half is a
# strided channel slice; its first 1x1 copies it where it is on the
# kernel route (× 0.25: stages 2 and 3, 7 + 3 units; × 1.0: stage 3)
COPIES = {"shufflenet_v2_x0_25": 10, "shufflenet_v2_x1_0": 3,
          "shufflenet_v2_swish": 3}


def seed_stats(model, rs):
    """On the JAX model: every BatchNorm2D's means N(0, 0.1), variances
    U(0.5, 1.5), γ ≈ 1 and β ≈ 0 with noise; every conv bias N(0, 0.1)."""
    for layer in model.sublayers():
        if isinstance(layer, pt.nn.BatchNorm2D):
            c = layer.num_features
            layer._mean._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)
            layer._variance._data = jnp.asarray(rs.uniform(0.5, 1.5, c),
                                                jnp.float32)
            layer.weight._data = jnp.asarray(1 + 0.1 * rs.randn(c),
                                             jnp.float32)
            layer.bias._data = jnp.asarray(0.1 * rs.randn(c), jnp.float32)
        elif isinstance(layer, pt.nn.Conv2D) and layer.bias is not None:
            layer.bias._data = jnp.asarray(
                0.1 * rs.randn(layer.out_channels), jnp.float32)


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture(scope="module", params=sorted(ZOO))
def ref(request):
    """The JAX model's state (numpy), an input, and its logits: eval
    forward, and the conv-bn-fold rewrite with the Pallas route."""
    name = request.param
    factory, kwargs, size, chans = ZOO[name]
    pt.seed(0)
    model = getattr(JM, factory)(num_classes=10, **kwargs)
    seed_stats(model, np.random.RandomState(1))
    model.eval()
    params = model.parameters()
    bufs = list(model.buffers())
    parrs = [p._data for p in params]
    barrs = [b._data for b in bufs]

    def fwd(parrs, barrs, x):
        with _bind(params, parrs), _bind(bufs, barrs), _tape.no_grad():
            return _logits(model(Tensor(x))).data

    x = np.random.RandomState(2).randn(2, chans, size, size).astype(
        np.float32)
    eager = np.array(jax.jit(fwd)(parrs, barrs, x))
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("default"):
        mp.setenv("PADDLE_TPU_CONV_EPILOGUE_IMPL", "pallas")
        # what rewrite_callable runs, traced and rewritten once
        res = rewrite_jaxpr(jax.make_jaxpr(fwd)(parrs, barrs, x),
                            default_rewrites(RULES))
        folded = eager if not res.fired else np.array(jax.jit(res.fn_flat)(
            *jax.tree_util.tree_leaves((parrs, barrs, x)))[0])
    state = {k: np.array(v._data) for k, v in model.state_dict().items()}
    port = getattr(TM, factory)(num_classes=10, device="cpu", **kwargs)
    port.load_state_dict(TM.params_from_jax(state, device="cpu"))
    return dict(name=name, state=state, x=x, eager=eager, folded=folded,
                fired=res.fired, port=port.eval())


def port_model(ref):
    """The port's model with the JAX model's state, eval (built once a
    module; ``fold_conv_bn`` leaves it as it was)."""
    return ref["port"]


def _forward(model, x):
    with torch.no_grad():
        return _logits(model(torch.from_numpy(x)))


def check_logits(got, want):
    got = got.detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_REL * scale, \
        (np.abs(got - want).max(), scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_params_from_jax_round_trips_bitwise(ref):
    state = TM.params_from_jax(ref["state"], device="cpu")
    model = port_model(ref)
    assert not model.training
    assert set(model.state_dict()) == set(ref["state"])
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), ref["state"][k], err_msg=k)
        assert torch.equal(state[k], v)


def test_unfolded_forward_matches_jax(ref):
    check_logits(_forward(port_model(ref), ref["x"]), ref["eager"])


def test_folded_forward_matches_jax_rewrite(ref):
    folded, _ = fold_conv_bn(port_model(ref))
    check_logits(_forward(folded, ref["x"]), ref["folded"])


def test_fold_fires_where_the_jax_pass_fires(ref):
    _, fired = fold_conv_bn(port_model(ref))
    routes = ROUTES.get(ref["name"], {})
    assert fired == {"conv-bn-fold": sum(routes.values())}
    # the JAX pass reports no key when it does not fire
    assert dict(ref["fired"]).get("conv-bn-fold", 0) == fired["conv-bn-fold"]


def test_kernel_sites_reach_the_kernel_entry(ref, monkeypatch):
    """Every site on the kernel route calls ``matmul_bias_act`` once a
    forward (the plain version here: the tensors are on the CPU), with
    K and N multiples of 8; the routed sites are exactly the 1x1 sites
    whose K or N is not; the row-wise inputs copied are as pinned for a
    channels-last input."""
    calls = []
    real = TK.matmul_bias_act

    def spy(x2, w, bias, relu=True, impl="auto"):
        # x2 is the site's NHWC view: its [M, K] rows
        calls.append(((x2.numel() // x2.shape[-1], x2.shape[-1]),
                      tuple(w.shape), relu))
        return real(x2, w, bias, relu=relu, impl=impl)

    monkeypatch.setattr(TK, "matmul_bias_act", spy)
    folded, _ = fold_conv_bn(port_model(ref))
    routes = ROUTES.get(ref["name"], {})
    assert site_routes(folded) == routes
    for m in folded.modules():
        if isinstance(m, ConvBnAct) and m.route == "routed":
            assert m.weight.shape[2:] == (1, 1)
            assert m.weight.shape[0] % 8 or m.weight.shape[1] % 8
    copies = real.input_copies
    launches = real.launches
    x = torch.from_numpy(ref["x"]).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        folded(x)
    assert len(calls) == routes.get("kernel", 0)
    assert all(k % 8 == 0 and n % 8 == 0 for (_, k), (_, n), _ in calls)
    assert sum(r for _, _, r in calls) == RELU_SITES.get(ref["name"], 0)
    assert real.input_copies - copies == COPIES.get(ref["name"], 0)
    assert real.launches == launches


FACTORIES = sorted(n for n in dir(TM) if n[0].islower()
                   and n != "params_from_jax" and callable(getattr(TM, n)))


@pytest.mark.parametrize("factory", FACTORIES)
def test_pretrained_raises(factory):
    with pytest.raises(NotImplementedError, match="pretrained"):
        getattr(TM, factory)(pretrained=True, device="cpu")


@pytest.mark.parametrize("name", ["mobilenet_v2", "inception_v3",
                                  "googlenet"])
def test_fold_refuses_a_training_model(name):
    factory, kwargs, size, _ = ZOO[name]
    model = getattr(TM, factory)(num_classes=10, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="eval"):
        fold_conv_bn(model)
    # training runs (the train step's slice), but a dropout draws its
    # mask only from a key stream it was given
    with pytest.raises(RuntimeError, match="generator"):
        model(torch.zeros(2, 3, size, size))


def test_googlenet_eval_aux_outputs_are_none():
    model = TM.googlenet(num_classes=7, device="cpu").eval()
    with torch.no_grad():
        out, aux1, aux2 = model(torch.zeros(1, 3, 64, 64))
    assert out.shape == (1, 7) and aux1 is None and aux2 is None
    assert {"aux1.fc2.weight", "aux2.conv.bias"} <= set(model.state_dict())


@pytest.mark.parametrize("scale", [0.25, 0.33, 0.5, 1.0, 1.5, 2.0])
def test_shufflenet_routes_1x1_sites_by_their_widths(scale):
    """At every scale a 1x1 site goes to the kernel exactly when its K
    and N are multiples of 8 (× 2.0's branches are 122 wide)."""
    from paddle_tpu_torch.models.shufflenetv2 import ShuffleNetV2
    folded, fired = fold_conv_bn(ShuffleNetV2(scale, num_classes=10,
                                              device="cpu").eval())
    assert fired == {"conv-bn-fold": 56}
    for m in folded.modules():
        if isinstance(m, ConvBnAct) and m.route in ("kernel", "routed"):
            k, n = (m.weight.shape if m.route == "kernel"
                    else m.weight.shape[1::-1])
            assert (m.route == "kernel") == (k % 8 == 0 and n % 8 == 0)


def test_channel_shuffle_keeps_channels_last():
    from paddle_tpu_torch.models.shufflenetv2 import channel_shuffle
    x = torch.arange(2 * 12 * 3 * 5, dtype=torch.float32).view(2, 12, 3, 5)
    want = x.view(2, 2, 6, 3, 5).transpose(1, 2).reshape(2, 12, 3, 5)
    got = channel_shuffle(x.contiguous(memory_format=torch.channels_last), 2)
    assert torch.equal(got, want) and torch.equal(channel_shuffle(x, 2), want)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("act", ["Hardswish", "Hardsigmoid", "ReLU6",
                                 "Swish"])
def test_activations_match_jax(act):
    from paddle_tpu_torch.models import _layers
    port = {"Hardswish": _layers.Hardswish, "Hardsigmoid": _layers.Hardsigmoid,
            "ReLU6": torch.nn.ReLU6, "Swish": torch.nn.SiLU}[act]
    x = np.random.RandomState(3).randn(4, 8, 5, 5).astype(np.float32) * 5
    want = np.asarray(getattr(pt.nn, act)()(pt.to_tensor(x)).data)
    got = port()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# parameters at published widths (1000 classes): AlexNet through
# Inception v3 equal the reference implementations' published counts
# (Inception v3 without its auxiliary head, which the JAX model lacks;
# GoogLeNet with both of its auxiliary heads)
PUBLISHED_PARAMS = {
    ("LeNet", ()): 61610, ("alexnet", ()): 61100840,
    ("vgg16", ()): 138357544, ("vgg16", (("batch_norm", True),)): 138365992,
    ("squeezenet1_1", ()): 1235496, ("mobilenet_v1", ()): 4231976,
    ("mobilenet_v2", ()): 3504872, ("mobilenet_v3_small", ()): 2542856,
    ("mobilenet_v3_large", ()): 5483032, ("shufflenet_v2_x1_0", ()): 2278604,
    ("shufflenet_v2_x0_5", ()): 1366792, ("densenet121", ()): 7978856,
    ("googlenet", ()): 13378280, ("inception_v3", ()): 23834568,
}


@pytest.mark.parametrize("factory,kwargs", sorted(PUBLISHED_PARAMS),
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(k for k, _ in v) or "default")
def test_factories_build_at_published_widths_on_the_cpu(factory, kwargs):
    model = getattr(TM, factory)(device="cpu", **dict(kwargs))
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == \
        PUBLISHED_PARAMS[(factory, kwargs)]
