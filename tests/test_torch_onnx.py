"""The port's ``onnx.export`` vs the JAX package's, on the cases of
``tests/test_onnx_export.py`` that need no port ``nn`` (ERNIE waits for
it), and on O2-decorated models.

Each JAX model is built with its own init and its weights go to the
port's model (``params_from_jax``; torch's ``Linear`` takes the
transpose, torch's affineless ``BatchNorm2d`` keeps its fresh statistics,
which are the JAX layer's). Both export on the same ``InputSpec``.

Contract (exact): the same node op types, inputs, outputs and
attributes in order; the same input and output value infos; each
initializer's bytes; the whole GraphProto's bytes apart from the graph's
name (the model's class name, equal here), and the rest of the
ModelProto. A model with an unmapped layer or op warns on both sides
and writes the port's ``.pdmodel``, which ``jit.load`` runs to the eager
forward's values bitwise. The ResNet-18 graph also runs through
``chip_smoke.onnx_eval`` (the card's evaluator, torch ops on the CPU)
within 1e-5 of the port's forward's largest logit.
"""
import warnings

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)
from torch import nn

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.jit import InputSpec as JSpec
from paddle_tpu.onnx import _proto as JP
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch import onnx as TO
from paddle_tpu_torch.models import _layers as L
from paddle_tpu_torch.models.llama import params_from_jax
from paddle_tpu_torch.onnx import _proto as P

import chip_smoke


def _state(jm):
    return {k: np.array(v._data.astype(jnp.float32)
                        if v._data.dtype == jnp.bfloat16 else v._data)
            for k, v in jm.state_dict().items()}


def _load(tm, jm, transpose=()):
    """The JAX model's weights into the port's (same names); keys in
    ``transpose`` are torch ``Linear`` weights, stored [out, in]."""
    st = _state(jm)
    for k in transpose:
        st[k] = np.ascontiguousarray(st[k].T)
    tm.load_state_dict(params_from_jax(st, device="cpu"), strict=False)
    return tm.eval()


def _export_both(tmp_path, jm, tm, shape, dtype="float32", warn=False):
    jm.eval()
    tmp_path.mkdir(exist_ok=True)
    jspec = [JSpec(shape, dtype=dtype)]
    tspec = [TJ.InputSpec(shape, dtype)]
    ctx = pytest.warns(UserWarning) if warn else warnings.catch_warnings()
    with ctx:
        jout = pt.onnx.export(jm, str(tmp_path / "jax"), input_spec=jspec)
    ctx = pytest.warns(UserWarning) if warn else warnings.catch_warnings()
    with ctx:
        tout = TO.export(tm, str(tmp_path / "port"), input_spec=tspec)
    return jout, tout


def _nodes(graph):
    out = []
    for n in P.fields(graph, 1):
        out.append((P.fields(n, 4)[0].decode(),
                    [i.decode() for i in P.fields(n, 1)],
                    [o.decode() for o in P.fields(n, 2)],
                    [bytes(a) for a in P.fields(n, 5)]))
    return out


def _inits(graph):
    return [(P.fields(t, 8)[0].decode(), P.fields(t, 2)[0],
             [v for f, w, v in P.parse(t) if f == 1 and w == 0],
             bytes(P.fields(t, 9)[0])) for t in P.fields(graph, 5)]


def _assert_same(jout, tout):
    """The JAX export and the port's export, field by field (module
    docstring); returns the port's bytes."""
    assert jout.endswith(".onnx") and tout.endswith(".onnx"), (jout, tout)
    jb, tb = open(jout, "rb").read(), open(tout, "rb").read()
    jg, tg = JP.fields(jb, 7)[0], P.fields(tb, 7)[0]
    assert [n[0] for n in _nodes(tg)] == [n[0] for n in _nodes(jg)]
    assert _nodes(tg) == _nodes(jg)
    assert _inits(tg) == _inits(jg)
    for f in (11, 12):      # input and output value infos
        assert P.fields(tg, f) == JP.fields(jg, f)
    assert [x for x in P.parse(tg) if x[0] != 2] == \
        [x for x in JP.parse(jg) if x[0] != 2]
    assert [x for x in P.parse(tb) if x[0] != 7] == \
        [x for x in JP.parse(jb) if x[0] != 7]
    return tb


def _op_types(blob):
    return [P.fields(n, 4)[0].decode()
            for n in P.fields(P.fields(blob, 7)[0], 1)]


def test_export_mlp(tmp_path):
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                          pt.nn.Dropout(0.5), pt.nn.Linear(8, 2))
    tm = _load(nn.Sequential(L.Linear(4, 8), nn.ReLU(), nn.Dropout(0.5),
                             L.Linear(8, 2)), jm)
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [None, 4]))
    assert _op_types(tb) == ["Gemm", "Relu", "Identity", "Gemm"]
    w = P.fields(P.fields(P.fields(tb, 7)[0], 5)[0], 9)[0]
    np.testing.assert_array_equal(
        np.frombuffer(w, np.float32).reshape(4, 8),
        tm[0].weight.detach().numpy())


def test_export_lenet(tmp_path):
    from paddle_tpu.models import LeNet as JLeNet
    from paddle_tpu_torch.models import LeNet
    pt.seed(1)
    jm = JLeNet(num_classes=10)
    tm = _load(LeNet(num_classes=10, device="cpu"), jm)
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [1, 1, 28, 28]))
    assert _op_types(tb) == ["Conv", "Relu", "MaxPool", "Conv", "Relu",
                             "MaxPool", "Reshape", "Gemm", "Gemm", "Gemm"]


def test_export_conv_bn_chain(tmp_path):
    pt.seed(2)
    jm = pt.nn.Sequential(
        pt.nn.Conv2D(3, 8, 3, stride=2, padding=1),
        pt.nn.BatchNorm2D(8), pt.nn.ReLU(),
        pt.nn.AdaptiveAvgPool2D((1, 1)), pt.nn.Flatten(),
        pt.nn.Linear(8, 4))
    tm = _load(nn.Sequential(
        L.conv(3, 8, 3, 2, 1, bias=True), L.BatchNorm2D(8), nn.ReLU(),
        nn.AdaptiveAvgPool2d((1, 1)), nn.Flatten(), L.Linear(8, 4)), jm)
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [1, 3, 16, 16]))
    assert _op_types(tb) == ["Conv", "BatchNormalization", "Relu",
                             "GlobalAveragePool", "Flatten", "Gemm"]


def test_export_dynamic_batch_opset_and_attrs(tmp_path):
    pt.seed(3)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.LeakyReLU(0.2),
                          pt.nn.Hardswish(), pt.nn.Softmax(axis=1))
    # torch's own layers: Linear [out, in], Softmax(dim)
    tm = _load(nn.Sequential(nn.Linear(4, 8), nn.LeakyReLU(0.2),
                             L.Hardswish(), nn.Softmax(dim=1)), jm,
               transpose=("0.weight",))
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [None, 4]))
    assert P.fields(P.fields(tb, 8)[0], 2)[0] == 14     # HardSwish


class Pre(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = L.Linear(4, 2)

    def forward(self, x):
        return self.fc(x / 255.0)


class Post(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = L.Linear(4, 2)

    def forward(self, x):
        return self.fc(x) * 2.0


def _jax_pre_post():
    class Pre(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x / 255.0)

    class Post(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x) * 2.0

    return Pre(), Post()


@pytest.mark.parametrize("which", [0, 1], ids=["pre", "post"])
def test_export_captures_functional_pre_post(tmp_path, which):
    pt.seed(4)
    jm = _jax_pre_post()[which]
    tm = _load((Pre, Post)[which](), jm)
    jout, tout = _export_both(tmp_path, jm, tm, [1, 4])
    tb = _assert_same(jout, tout)
    # the graph's name is the class name, the same on both sides here
    assert open(tout, "rb").read() == open(jout, "rb").read()
    assert ("Div", "Mul")[which] in _op_types(tb)


def test_export_leaf_and_affineless_bn(tmp_path):
    pt.seed(5)
    jm = pt.nn.Linear(4, 8)
    tm = _load(L.Linear(4, 8), jm)
    tb = _assert_same(*_export_both(tmp_path / "leaf", jm, tm, [1, 4]))
    assert _op_types(tb) == ["Gemm"]
    jm = pt.nn.Sequential(
        pt.nn.Conv2D(3, 4, 1),
        pt.nn.BatchNorm2D(4, weight_attr=False, bias_attr=False))
    tm = _load(nn.Sequential(nn.Conv2d(3, 4, 1),
                             nn.BatchNorm2d(4, affine=False)), jm)
    tb = _assert_same(*_export_both(tmp_path / "bn", jm, tm, [1, 3, 4, 4]))
    assert _op_types(tb) == ["Conv", "BatchNormalization"]


def test_export_string_padding_falls_back(tmp_path):
    pt.seed(6)
    jm = pt.nn.Sequential(pt.nn.Conv2D(3, 4, 3, padding="SAME"),
                          pt.nn.ReLU())
    tm = _load(nn.Sequential(nn.Conv2d(3, 4, 3, padding="same"), nn.ReLU()),
               jm)
    jout, tout = _export_both(tmp_path, jm, tm, [1, 3, 8, 8], warn=True)
    assert jout.endswith(".pdmodel") and tout.endswith(".pdmodel")
    x = torch.randn(1, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    got = TJ.load(str(tmp_path / "port"))(x)
    with torch.no_grad():
        assert torch.equal(got, tm(x))


def test_export_resnet_residual_graph(tmp_path):
    from paddle_tpu.vision.models import resnet18 as jresnet18
    from paddle_tpu_torch.models.resnet import resnet18
    pt.seed(7)
    jm = jresnet18(num_classes=4)
    tm = _load(resnet18(num_classes=4, device="cpu"), jm)
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [1, 3, 32, 32]))
    ops = _op_types(tb)
    assert ops.count("Add") == 8 and ops.count("Conv") == 20
    assert "GlobalAveragePool" in ops and ops[-2:] == ["Reshape", "Gemm"]
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tm(x)
    got = chip_smoke.onnx_eval(tb, x)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_export_memory_format_ops_write_no_node(tmp_path):
    """``contiguous(memory_format=...)`` and ``to(memory_format=...)``
    between layers change the layout only: the graph equals the JAX
    export of the same model without them."""
    class JGlue(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = pt.nn.Conv2D(3, 4, 3, padding=1)
            self.bn = pt.nn.BatchNorm2D(4)
            self.relu = pt.nn.ReLU()

        def forward(self, x):
            return self.relu(self.bn(self.conv(x)))

    class Glue(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = L.conv(3, 4, 3, 1, 1, bias=True)
            self.bn = L.BatchNorm2D(4)
            self.relu = nn.ReLU()

        def forward(self, x):
            x = self.conv(x).contiguous(memory_format=torch.channels_last)
            x = self.bn(x).to(memory_format=torch.contiguous_format)
            return self.relu(x)

    pt.seed(10)
    jm = JGlue()
    tm = _load(Glue(), jm)
    tb = _assert_same(*_export_both(tmp_path, jm, tm, [1, 3, 8, 8]))
    assert _op_types(tb) == ["Conv", "BatchNormalization", "Relu"]


def test_export_unsupported_op_falls_back(tmp_path):
    class JOdd(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 4)

        def forward(self, x):
            return pt.cumsum(self.fc(x), axis=1)

    class Odd(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = L.Linear(4, 4)

        def forward(self, x):
            return torch.cumsum(self.fc(x), 1)

    pt.seed(8)
    jm = JOdd()
    tm = _load(Odd(), jm)
    jout, tout = _export_both(tmp_path, jm, tm, [1, 4], warn=True)
    assert jout.endswith(".pdmodel") and tout.endswith(".pdmodel")
    x = torch.randn(1, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(TJ.load(str(tmp_path / "port"))(x), tm(x))


def test_export_int_scalar_const_dtype(tmp_path):
    class JAddOne(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.out = pt.nn.Identity()

        def forward(self, x):
            return self.out(x + 1)

    class AddOne(nn.Module):
        def __init__(self):
            super().__init__()
            self.out = nn.Identity()

        def forward(self, x):
            return self.out(x + 1)

    tb = _assert_same(*_export_both(tmp_path, JAddOne(), AddOne(), [2, 3],
                                    dtype="int32"))
    assert _op_types(tb) == ["Add", "Identity"]
    inits = chip_smoke.onnx_initializers(tb)
    assert [v.dtype for v in inits.values()] == [np.int32]
    assert [v.shape for v in inits.values()] == [()]


def test_export_o2_decorated_matches_jax(tmp_path):
    """O2 models: bf16 parameters (BN's f32) widen to f32 initializers;
    an MLP fed f32 (Linear promotes) and a conv chain fed bf16 (a JAX
    conv takes only its weight's dtype)."""
    pt.seed(9)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                          pt.nn.Linear(8, 2))
    tm = _load(nn.Sequential(L.Linear(4, 8), nn.ReLU(), L.Linear(8, 2)), jm)
    pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    TA.decorate(tm, level="O2", dtype="bfloat16")
    assert tm[0].weight.dtype == torch.bfloat16
    _assert_same(*_export_both(tmp_path / "mlp", jm, tm, [None, 4]))
    jm = pt.nn.Sequential(
        pt.nn.Conv2D(3, 8, 3, padding=1), pt.nn.BatchNorm2D(8),
        pt.nn.ReLU(), pt.nn.AdaptiveAvgPool2D((1, 1)), pt.nn.Flatten(),
        pt.nn.Linear(8, 4))
    tm = _load(nn.Sequential(
        L.conv(3, 8, 3, 1, 1, bias=True), L.BatchNorm2D(8), nn.ReLU(),
        nn.AdaptiveAvgPool2d((1, 1)), nn.Flatten(), L.Linear(8, 4)), jm)
    pt.amp.decorate(jm, level="O2", dtype="bfloat16")
    TA.decorate(tm, level="O2", dtype="bfloat16")
    assert tm[1].weight.dtype == torch.float32
    _assert_same(*_export_both(tmp_path / "conv", jm, tm, [1, 3, 8, 8],
                               dtype="bfloat16"))
