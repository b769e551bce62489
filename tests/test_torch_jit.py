"""The port's ``jit`` vs the JAX package's: ``to_static`` (a function, a
module in training, ``lower``, ``full_graph=False`` on a data-dependent
break), ``save`` / ``load`` with static, ``None``, ``-1`` and shared
string dims, ``bucketing``, and the conv epilogue's PyTorch operator
(``paddle_tpu::matmul_bias_act``) that keeps the hand-written kernel one
node of an exported or compiled graph.

Each case runs the JAX function and the port's on the same numpy inputs
made from a seed, the port's weights copied from the JAX model's.
Contract (f32): values and gradients within rtol 1e-5 / atol 1e-6 of
JAX's (the JAX tests' 1e-5; training losses over 5 SGD steps within
rtol 1e-5); saved programs equal the eager module bitwise, and the JAX
saved program within rtol 1e-4 / atol 1e-5 (``tests/test_jit_io.py``'s
bound); bucket sizes equal. The port compiles with ``backend=
"aot_eager"`` here: inductor takes tens of seconds a function on the
CPU, and the card runs it (``chip_smoke.py`` phase 20).
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.jit import bucketing as JB
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.analysis import fold_conv_bn, site_routes
from paddle_tpu_torch.jit import bucketing as TB
from paddle_tpu_torch.models import _layers
from paddle_tpu_torch.ops.kernels import conv_epilogue as TK

RTOL, ATOL = 1e-5, 1e-6
SAVE_RTOL, SAVE_ATOL = 1e-4, 1e-5
BACKEND = "aot_eager"


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_linears(jm):
    """The port's ``Sequential`` of the JAX ``Sequential``'s Linears (the
    port's ``Linear``: the same ``[in, out]`` weight) and ReLUs."""
    mods = []
    for jl in jm:
        if isinstance(jl, pt.nn.Linear):
            w = np.array(jl.weight._data)
            tl = _layers.Linear(*w.shape)
            with torch.no_grad():
                tl.weight.copy_(_t(w))
                tl.bias.copy_(_t(jl.bias._data))
            mods.append(tl)
        else:
            mods.append(nn.ReLU())
    return nn.Sequential(*mods)


# --------------------------------------------------------------------------
# to_static
# --------------------------------------------------------------------------

def test_to_static_function_matches_jax():
    rs = np.random.RandomState(0)
    a = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(4, 5).astype(np.float32)

    @pt.jit.to_static
    def jf(x, y):
        return pt.matmul(x, y) + 1.0

    @TJ.to_static(backend=BACKEND)
    def tf(x, y):
        return torch.matmul(x, y) + 1.0

    want = jf(pt.to_tensor(a), pt.to_tensor(b)).numpy()
    got = tf(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert tf.graph_break_stats["segments"] == 1
    tf(_t(a), _t(b))                       # the same signature: no capture
    assert tf.graph_break_stats["segments"] == 1
    assert tf.graph_break_stats["cache_hits"] == 1
    tf(_t(a[:2]), _t(b))                   # a new signature: its program
    assert tf.graph_break_stats["segments"] == 2
    assert tf.dygraph_function.__name__ == "tf"


def test_to_static_layer_training_matches_jax():
    """A module wrapped by ``to_static`` trains: 5 SGD steps, each loss
    and the first step's gradients within f32 tolerance of JAX's."""
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                          pt.nn.Linear(16, 4))
    tm = _port_linears(jm)
    assert pt.jit.to_static(jm) is jm
    assert TJ.to_static(tm, backend=BACKEND) is tm
    rs = np.random.RandomState(1)
    x = rs.randn(4, 8).astype(np.float32)
    y = rs.randn(4, 4).astype(np.float32)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    jl, tl = [], []
    for i in range(5):
        loss = ((jm(pt.to_tensor(x)) - pt.to_tensor(y)) ** 2).mean()
        loss.backward()
        if i == 0:
            jgrads = [p.grad.numpy().copy() for p in jm.parameters()]
        opt.step()
        opt.clear_grad()
        jl.append(float(loss.numpy()))
        tloss = ((tm(_t(x)) - _t(y)) ** 2).mean()
        tloss.backward()
        if i == 0:
            tgrads = [p.grad.numpy().copy() for p in tm.parameters()]
        with torch.no_grad():
            for p in tm.parameters():
                p -= 0.1 * p.grad
                p.grad = None
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert tm.forward.graph_break_stats["segments"] >= 1


@pytest.mark.parametrize("first", ["f32", "o1"])
def test_to_static_program_per_amp_state(first):
    """A module captured under one AMP state and called under the other
    gets a program of its own: under O1 auto_cast its output is the
    eager module's under O1 (bf16, and within bf16 tolerance of the JAX
    module's under O1), outside it the f32 eager module's."""
    from paddle_tpu_torch import amp as TA
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                          pt.nn.Linear(16, 4))
    tm = _port_linears(jm)
    eager = _port_linears(jm)
    TJ.to_static(tm, backend=BACKEND)
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    with pt.amp.auto_cast():
        jo1 = np.asarray(jm(pt.to_tensor(x)).numpy(), np.float32)
    order = ("f32", "o1") if first == "f32" else ("o1", "f32")
    with torch.no_grad():
        for state in order + order:
            if state == "o1":
                with TA.auto_cast():
                    got, want = tm(_t(x)), eager(_t(x))
                assert got.dtype == torch.bfloat16
                np.testing.assert_allclose(got.float().numpy(), jo1,
                                           rtol=2e-2, atol=2e-2)
            else:
                got, want = tm(_t(x)), eager(_t(x))
                assert got.dtype == torch.float32
            assert torch.equal(got, want), state
    stats = tm.forward.graph_break_stats
    assert stats["segments"] == 2 and stats["cache_hits"] == 2, stats


def test_to_static_lower_gives_the_graph_text():
    @pt.jit.to_static
    def jf(x):
        return pt.exp(x)

    @TJ.to_static(backend=BACKEND)
    def tf(x):
        return torch.exp(x)

    jtxt = jf.lower(pt.to_tensor(np.ones((2, 2), np.float32)))
    ttxt = tf.lower(torch.ones(2, 2))
    assert "exponential" in jtxt
    assert "aten.exp" in ttxt and "f32[2, 2]" in ttxt


def _chain(x, n, mod):
    for _ in range(n):
        x = mod.tanh(x * 1.01 + 0.01)
    return x


def _break_fn(mod, to_float):
    def f(x):
        h = _chain(x, 5, mod)
        if to_float(h.mean()) > 0:           # the graph break
            h = h + 1.0
        else:
            h = h - 1.0
        return _chain(h * h, 5, mod)
    return f


def test_to_static_graph_break_matches_jax():
    """``full_graph=False`` on a data-dependent ``if``: both branches'
    values and the gradients equal JAX's segment mode and the eager
    function; the captured graphs and the break are counted, and the
    programs are reused."""
    jf = pt.jit.to_static(_break_fn(pt, lambda t: float(t.numpy())),
                          full_graph=False)
    tf = TJ.to_static(_break_fn(torch, float), full_graph=False,
                      backend=BACKEND)
    eager = _break_fn(torch, float)
    for v in ([0.5, 1.0], [-2.0, -1.5]):
        x = np.asarray(v, np.float32)
        jx = pt.to_tensor(x, stop_gradient=False)
        jy = jf(jx)
        jy.sum().backward()
        tx = _t(x).requires_grad_()
        ty = tf(tx)
        ty.sum().backward()
        ex = _t(x).requires_grad_()
        ey = eager(ex)
        ey.sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ty.detach().numpy(),
                                   ey.detach().numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tx.grad.numpy(), ex.grad.numpy(),
                                   rtol=RTOL, atol=ATOL)
    js, ts = jf.graph_break_stats, tf.graph_break_stats
    assert js["segments"] >= 2
    # the first call breaks once and captures the graph before the break
    # and the rest of the branch it took; the second, whose value fails
    # the resumed graph's guard on it, the rest of the other branch
    assert ts["segments"] == 3 and ts["graph_breaks"] == 1, (ts, js)
    assert ts["ops_recorded"] > 0
    # the first input again: every program it needs is cached (a float
    # read at a break is a guard of the resumed graph: another value of
    # it, or an input that does not require grad, captures anew)
    tf(_t(np.asarray([0.5, 1.0], np.float32)).requires_grad_())
    ts2 = tf.graph_break_stats
    assert ts2["segments"] == 3 and ts2["cache_hits"] == 1, ts2


def test_to_static_full_graph_raises_on_a_break():
    jf = pt.jit.to_static(_break_fn(pt, lambda t: float(t.numpy())),
                          full_graph=True)
    tf = TJ.to_static(_break_fn(torch, float), backend=BACKEND)
    with pytest.raises(Exception):
        jf(pt.to_tensor(np.ones(2, np.float32)))
    with pytest.raises(torch._dynamo.exc.TorchDynamoException):
        tf(torch.ones(2))


def test_switches_match_jax():
    def f(x):
        return x

    for mod in (pt.jit, TJ):
        assert mod.not_to_static(f) is f
        assert mod.not_to_static()(f) is f
        mod.enable_to_static(True)
        mod.set_code_level(100)
        mod.set_verbosity(0)
        assert "m_ignored" in mod.ignore_module(["m_ignored"])


# --------------------------------------------------------------------------
# save / load
# --------------------------------------------------------------------------

def _jax_loaded(jm, path, specs):
    pt.jit.save(jm, path, input_spec=[pt.jit.InputSpec(s) for s in specs])
    return pt.jit.load(path)


def _port_loaded(tm, path, specs):
    TJ.save(tm, path, input_spec=[TJ.InputSpec(s) for s in specs])
    return TJ.load(path)


def _np(out):
    out = out[0] if isinstance(out, (list, tuple)) else out
    return out.numpy() if isinstance(out, torch.Tensor) else \
        np.asarray(out.data)


def test_save_load_static_shape_matches_jax(tmp_path):
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                          pt.nn.Linear(8, 2))
    tm = _port_linears(jm).eval()
    jl = _jax_loaded(jm, str(tmp_path / "j"), [[3, 4]])
    tl = _port_loaded(tm, str(tmp_path / "t"), [[3, 4]])
    assert tl.num_inputs == jl.num_inputs == 1
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    got = _np(tl(_t(x)))
    np.testing.assert_allclose(got, _np(jl(pt.to_tensor(x))),
                               rtol=SAVE_RTOL, atol=SAVE_ATOL)
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(_t(x)).numpy())
    assert tl.eval() is tl and jl.eval() is jl
    for loaded in (jl, tl):
        with pytest.raises(RuntimeError, match="inference-only"):
            loaded.train()


class _TwoIn(nn.Module):
    def __init__(self, fc):
        super().__init__()
        self.fc = fc

    def forward(self, a, b):
        return self.fc(a + b)


# spec pairs: None and -1 at axis 0 share "batch"; equal string dims share
# their name
TWO_IN_SPECS = {"none": [[None, 6], [None, 6]],
                "minus_one": [[-1, 6], [-1, 6]],
                "string": [["n", 6], ["n", 6]]}


@pytest.mark.parametrize("kind", sorted(TWO_IN_SPECS))
def test_save_two_inputs_shared_dims_match_jax(tmp_path, kind):
    class JTwoIn(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(6, 2)

        def forward(self, a, b):
            return self.fc(a + b)

    pt.seed(0)
    jm = JTwoIn()
    tm = _TwoIn(_port_linears([jm.fc])[0])
    specs = TWO_IN_SPECS[kind]
    jl = _jax_loaded(jm, str(tmp_path / "j"), specs)
    tl = _port_loaded(tm, str(tmp_path / "t"), specs)
    assert tl.num_inputs == 2
    for bs in (1, 3, 7):
        rs = np.random.RandomState(bs)
        a = rs.randn(bs, 6).astype(np.float32)
        b = rs.randn(bs, 6).astype(np.float32)
        got = _np(tl(_t(a), _t(b)))
        assert got.shape == (bs, 2)
        np.testing.assert_allclose(got, _np(jl(a, b)), rtol=SAVE_RTOL,
                                   atol=SAVE_ATOL)


def test_save_unique_inner_dims(tmp_path):
    """``None`` / ``-1`` past axis 0 give each input a dim of its own:
    the program takes any sequence length, independently per input."""
    class Pool(nn.Module):
        def forward(self, a, b):
            return a.sum(1) + b.mean(1)

    tl = _port_loaded(Pool(), str(tmp_path / "p"), [[None, -1], [None, None]])
    for n, (ta, tb) in ((1, (1, 5)), (4, (3, 2))):
        a, b = torch.randn(n, ta), torch.randn(n, tb)
        torch.testing.assert_close(tl(a, b), a.sum(1) + b.mean(1))
    with pytest.raises(Exception):
        tl(torch.randn(2, 3), torch.randn(3, 3))   # batches differ


def test_load_reads_only_its_own_artifacts(tmp_path):
    pt.seed(0)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 2))
    pt.jit.save(jm, str(tmp_path / "j"),
                input_spec=[pt.jit.InputSpec([1, 4])])
    with pytest.raises(Exception):
        TJ.load(str(tmp_path / "j"))
    with pytest.raises(TypeError):
        TJ.save(lambda x: x, str(tmp_path / "f"), [TJ.InputSpec([1])])
    with pytest.raises(ValueError, match="input_spec"):
        TJ.save(nn.Linear(2, 2), str(tmp_path / "f"))


def _bottlenecks():
    """A folded stack of 1x1 conv → BN → relu sites the kernel takes
    (channels multiples of 8), one with a residual add, and a 3x3."""
    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1, self.b1 = _layers.conv(8, 16, 1), _layers.BatchNorm2D(16)
            self.c2, self.b2 = _layers.conv(16, 16, 3, padding=1), \
                _layers.BatchNorm2D(16)
            self.c3, self.b3 = _layers.conv(16, 8, 1), _layers.BatchNorm2D(8)
            self.relu = nn.ReLU()

        def forward(self, x):
            h = self.relu(self.b1(self.c1(x)))
            h = self.relu(self.b2(self.c2(h)))
            return self.relu(self.b3(self.c3(h)) + x)

    torch.manual_seed(0)
    net = Net()
    _layers.init_params(net, None)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, _layers.BatchNorm2D):
                m._mean.normal_(0, 0.1)
                m._variance.uniform_(0.5, 1.5)
    return net.eval()


def test_exported_fold_keeps_one_operator_node_a_site(tmp_path):
    """A folded model saved with a dynamic batch: one
    ``paddle_tpu::matmul_bias_act`` node per kernel-route site, the
    program equal to the folded eager model bitwise at B 1, 3 and 7, and
    copying a site's input when it runs exactly where the eager forward
    does (the NCHW input at the first site; nothing for a channels-last
    one)."""
    folded, fired = fold_conv_bn(_bottlenecks())
    assert fired == {"conv-bn-fold": 3}
    assert site_routes(folded) == {"kernel": 2, "conv": 1}
    loaded = _port_loaded(folded, str(tmp_path / "f"), [[None, 8, 6, 6]])
    nodes = [n for n in loaded.program.graph.nodes
             if n.op == "call_function" and
             str(n.target).startswith("paddle_tpu.matmul_bias_act")]
    assert len(nodes) == 2
    for B in (1, 3, 7):
        for fmt, copies in ((torch.contiguous_format, 1),
                            (torch.channels_last, 0)):
            x = torch.randn(B, 8, 6, 6).contiguous(memory_format=fmt)
            before = TK.matmul_bias_act.input_copies
            with torch.no_grad():
                got = loaded(x)
            program = TK.matmul_bias_act.input_copies - before
            with torch.no_grad():
                want = folded(x)
            eager = TK.matmul_bias_act.input_copies - before - program
            assert torch.equal(got, want)
            assert program == eager == copies


def test_compiled_fold_keeps_the_operator():
    """``to_static`` over a folded model: the graph holds the operator
    (which runs the plain version on CPU tensors), values bitwise."""
    folded, _ = fold_conv_bn(_bottlenecks())
    graphs = []
    real = TJ.StaticFunction._count

    def spy(self, gm, example_inputs):
        graphs.append(gm)
        return real(self, gm, example_inputs)

    x = torch.randn(2, 8, 6, 6)
    with torch.no_grad():
        want = folded(x)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TJ.StaticFunction, "_count", spy)
        f = TJ.to_static(lambda t: folded(t), backend=BACKEND)
        with torch.no_grad():
            got = f(x)
    assert torch.equal(got, want)
    ops = [n for gm in graphs for n in gm.graph.nodes
           if "matmul_bias_act" in str(n.target)]
    assert len(ops) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_epilogue_operator_opcheck(dtype):
    """``torch.library.opcheck`` on CPU tensors (the plain version): the
    schema, the fake version and the operator's registration."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    x2 = torch.randn(37, 16, generator=g).to(dt)
    w = torch.randn(16, 24, generator=g).to(dt)
    b = torch.randn(24, generator=g)
    op = torch.ops.paddle_tpu.matmul_bias_act.default
    for relu in (True, False):
        torch.library.opcheck(op, (x2, w, b, relu, "auto"))
        assert torch.equal(op(x2, w, b, relu, "auto"),
                           TK.matmul_bias_act_reference(x2, w, b, relu))
    # an NHWC view of an NCHW activation (strided: copied when it runs)
    # and of a channels-last one (read in place)
    x = torch.randn(2, 16, 3, 5, generator=g).to(dt)
    rows = x.permute(0, 2, 3, 1).reshape(-1, 16)
    for act in (x, x.contiguous(memory_format=torch.channels_last)):
        nhwc = act.permute(0, 2, 3, 1)
        torch.library.opcheck(op, (nhwc, w, b, True, "auto"))
        assert torch.equal(op(nhwc, w, b, True, "auto"),
                           TK.matmul_bias_act_reference(rows, w, b, True))
    assert TK.OP_NAME == "paddle_tpu::matmul_bias_act"


# --------------------------------------------------------------------------
# bucketing
# --------------------------------------------------------------------------

def test_bucket_ladder_matches_jax():
    for n in list(range(1, 300)) + [4095, 4096, 4097, 32768]:
        assert TB.bucket_size(n) == JB.bucket_size(n)
    for n in range(1, 101):
        assert TB.bucket_size(n, (100, 4, 16)) == JB.bucket_size(
            n, (100, 4, 16))
    for mod in (TB, JB):
        with pytest.raises(ValueError):
            mod.bucket_size(10 ** 9)
        with pytest.raises(ValueError):
            mod.bucket_size(101, (4, 16, 100))
    assert TB.DEFAULT_BUCKETS == JB.DEFAULT_BUCKETS


def test_bucketed_pads_slices_and_masks_like_jax():
    seen = []

    @TB.bucketed(axis=0)
    def tf(x):
        seen.append(x.shape[0])
        return x * 2.0

    @JB.bucketed(axis=0)
    def jf(x):
        return x * 2.0

    for n in (3, 4, 2, 7, 8, 5, 6, 1):
        x = np.random.RandomState(n).randn(n, 4).astype(np.float32)
        got = tf(x)
        assert got.shape == (n, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf(x)))
    assert set(seen) == {1, 2, 4, 8}

    def mean_rows(ar):
        def f(x, valid_len):
            mask = (ar(x.shape[0]) < valid_len)[:, None]
            return (x * mask).sum() / (valid_len * x.shape[1])
        return f

    x = np.full((5, 2), 3.0, np.float32)
    tm = TB.bucketed(mean_rows(torch.arange), axis=0,
                     with_length=True)
    jm = JB.bucketed(mean_rows(jnp.arange), axis=0, with_length=True)
    np.testing.assert_allclose(float(tm(x)), float(jm(x)), rtol=1e-6)
    np.testing.assert_allclose(float(tm(x)), 3.0, rtol=1e-6)

    def prod_all(x, valid_len):
        return x.prod()

    for mod in (TB, JB):
        f = mod.bucketed(prod_all, axis=0, buckets=(4, 16), pad_value=1.0,
                         with_length=True)
        np.testing.assert_allclose(float(f(np.full((3,), 2.0,
                                                   np.float32))), 8.0)
        g = mod.bucketed(lambda a, b: a + b, axis=-1)
        with pytest.raises(ValueError, match="agree"):
            g(np.ones((2, 3), np.float32), np.ones((2, 4), np.float32))
        h = mod.bucketed(lambda a: a * 1.0, axis=-1)
        assert tuple(h(np.ones((2, 3), np.float32)).shape) == (2, 3)
