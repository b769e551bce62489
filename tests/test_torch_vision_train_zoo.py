"""The port's vision train step on the zoo vs the JAX package's: one step
of ``tests/test_vision_zoo.py``'s six trained families at its sizes
(MobileNetV2 × 0.25, VGG-11, SqueezeNet 1.1, DenseNet-121, ShuffleNetV2
× 0.25 at 32² or 64², Inception v3 at 75²), AlexNet (dropout) and
GoogLeNet with its auxiliary heads (64²), B 4, 3 classes, against
``tools/resnet_bench.py``'s JAX step (``test_torch_vision_train.JaxStep``)
from the same state and the same seed.

Contract: the dropout keys of the step are drawn in the same order and
are equal bitwise (the masks then are, ``test_dropout_matches_jax_
bitwise``). In f32, the models without BN (VGG-11, SqueezeNet, AlexNet,
GoogLeNet) meet the f32 floors (``test_torch_vision_train.FLOORS``).
The deep BNs of the others normalise over 4 values a channel at their
last stages, where f32 resolves the step only to 4e-3 (DenseNet) to
2e-1 (Inception v3) of the gradient scale, on both sides; so those four
are held in f64 on both sides at the ResNets' bounds (loss rtol 1e-5,
gradients and buffers within 1e-5 of their scale, parameters atol 3e-5;
the cross entropy's statistics f32 on both, the dropout masks drawn
from f32 uniforms on both), and their f32 step as accurate as JAX's:
its distance from the JAX f64 step within ``COND`` times the JAX f32
step's, or the floors (the loss's raised to ``BN_F32_FLOORS``).

Split from ``test_torch_vision_train.py`` because building the JAX train
steps takes ~2 minutes on one CPU worker; DenseNet-121
(``test_torch_vision_train_densenet.py``) and Inception v3 / GoogLeNet
(``test_torch_vision_train_inception.py``) sit in files of their own,
which run this file's checks (``check_f32_step``, ``check_f64_step``),
so that no one file holds a test worker for long.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax

import paddle_tpu as pt
from paddle_tpu.core import generator as jgen
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.core import Generator
from paddle_tpu_torch.vision import train as TT
from test_torch_vision_train import (FLOORS, JaxStep, _data,
                                     check_conditioned, check_step, gaps,
                                     port_of, port_run)

# tests/test_vision_zoo.py's six families and sizes, AlexNet (dropout)
# and GoogLeNet with its auxiliary heads: (factory, kwargs, image size)
ZOO = {
    "mobilenet_v2": ("mobilenet_v2", {"scale": 0.25}, 32),
    "vgg11": ("vgg11", {}, 32),
    "squeezenet1_1": ("squeezenet1_1", {}, 64),
    "densenet121": ("densenet121", {}, 32),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", {}, 32),
    "inception_v3": ("inception_v3", {}, 75),
    "alexnet": ("alexnet", {}, 64),
    "googlenet": ("googlenet", {}, 64),
}
# dropout keys one step draws (layers with p > 0, in call order)
ZOO_KEYS = {"vgg11": 2, "squeezenet1_1": 1, "mobilenet_v2": 1,
            "inception_v3": 1, "alexnet": 2, "googlenet": 3}
DROP_SEED = 21
# the models whose steps run in files of their own (module docstring)
SPLIT = ("densenet121", "inception_v3", "googlenet")


# the families with BN: held in f64 on both sides
BN_FAMILIES = ("densenet121", "inception_v3", "mobilenet_v2",
               "shufflenet_v2_x0_25")
# their f32 loss: the last BNs normalise over 4 values a channel, so an
# f32 rounding moves the logits far more than elsewhere; the loss's
# distance from the JAX f64 step, measured: the port 5.6e-4 / 1.4e-5,
# JAX 2.9e-5 / 3.0e-6 (Inception v3 / MobileNetV2)
BN_F32_FLOORS = dict(FLOORS, loss=2e-3)


@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    """The JAX model's state, the batch, and the JAX step's records (f32;
    f64 too for a BN family) with the dropout keys each drew."""
    factory, kwargs, size = ZOO[name]
    kwargs = dict(kwargs, num_classes=3)
    pt.seed(0)
    jm = getattr(JM, factory)(**kwargs)
    jm.train()
    x, y = _data(4, 3, size, 9, classes=3)
    step = JaxStep(jm)
    real, real_bernoulli = jgen.Generator.next_key, jax.random.bernoulli
    ref = dict(jm=jm, x=x, y=y, kwargs=kwargs, factory=factory)
    for dtype in ((np.float32, np.float64) if name in BN_FAMILIES
                  else (np.float32,)):
        keys = []

        def spy(self):
            # drawn at trace time as constants (a split inside the trace
            # would leave a tracer in the generator): the same keys
            with jax.ensure_compile_time_eval():
                k = real(self)
            keys.append(np.asarray(k))
            return k

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgen.Generator, "next_key", spy)
            # under x64 JAX would draw the mask from f64 uniforms; the
            # f32 step's (and the port's) are f32
            mp.setattr(jax.random, "bernoulli",
                       lambda k, p, shape: real_bernoulli(
                           k, np.float32(p), shape))
            pt.seed(DROP_SEED)
            ref[dtype] = step.run(x, y, 1, dtype=dtype)
        ref[dtype, "keys"] = keys
    return ref


def _port_step(ref, name, dtype):
    """The port's step from the JAX model's state with a key stream of
    DROP_SEED; (record, keys)."""
    gen = Generator(DROP_SEED)
    keys, real = [], gen.next_key
    gen.next_key = lambda: keys.append(real()) or keys[-1]
    loss_fn = TT.googlenet_aux_loss if name == "googlenet" else None
    port = port_of(ref["jm"], ref["factory"], ref["kwargs"])
    return port_run(port, ref["x"], ref["y"], 1, loss_fn=loss_fn,
                    generator=gen, dtype=dtype), keys


def _check_keys(jkeys, tkeys, name):
    assert len(jkeys) == len(tkeys) == ZOO_KEYS.get(name, 0)
    for a, b in zip(jkeys, tkeys):
        np.testing.assert_array_equal(b.numpy().astype(np.uint32), a)


def check_f32_step(name):
    """One f32 step: the keys; the floors, or for a BN family the JAX
    f32 step's distance from the JAX f64 step times ``COND``."""
    ref = _jax_ref(name)
    got, tkeys = _port_step(ref, name, torch.float32)
    _check_keys(ref[np.float32, "keys"], tkeys, name)
    assert np.isfinite(got["losses"]).all()
    want = ref[np.float32]
    if name in BN_FAMILIES:
        check_conditioned(gaps(got, ref[np.float64]),
                          gaps(want, ref[np.float64]), BN_F32_FLOORS)
    else:
        check_conditioned(gaps(got, want), dict.fromkeys(FLOORS, 0.0))


def check_f64_step(name):
    """One f64 step of a BN family on both sides: the keys, the loss,
    every gradient, the parameters and BN buffers after it at the
    ResNets' bounds (``check_step``)."""
    ref = _jax_ref(name)
    got, tkeys = _port_step(ref, name, torch.float64)
    _check_keys(ref[np.float64, "keys"], tkeys, name)
    check_step(got, ref[np.float64])


@pytest.mark.parametrize("name", [n for n in sorted(ZOO) if n not in SPLIT])
def test_zoo_train_step_matches_jax(name):
    check_f32_step(name)


@pytest.mark.parametrize("name", [n for n in BN_FAMILIES if n not in SPLIT])
def test_zoo_train_step_f64_matches_jax(name):
    check_f64_step(name)
