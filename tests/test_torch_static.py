"""The port's ``static`` and ``static.nn`` vs the JAX package's.

The 18 cases of ``tests/test_control_flow.py`` run on both sides: the
JAX side as that file runs them (``paddle_tpu`` tensors, its tape, its
``jit.to_static``), the port on torch tensors, eager and under
``jit.to_static`` (``backend="aot_eager"``), where each ``cond`` /
``case`` / ``switch_case`` / ``while_loop`` must stay one higher-order
node of ONE captured graph (no graph break; ``lower()`` names the
node). Values and gradients equal the JAX package's (they are small
integers and their products, exact in f32). Then the rest of
``static``: the helpers against the JAX functions on the same inputs,
and the raises that point at ``jit.save`` / ``create_predictor``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import static as JS
from paddle_tpu.static import nn as jnn
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch import static as TS
from paddle_tpu_torch.static import nn as snn

BACKEND = "aot_eager"


def t(x, sg=False):
    return pt.to_tensor(np.asarray(x, np.float32), stop_gradient=sg)


def tt(x, grad=True):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _eq(port, jax_tensor):
    np.testing.assert_array_equal(
        port.detach().numpy(), np.asarray(jax_tensor.numpy()))


def _one_graph(f):
    stats = f.graph_break_stats
    assert stats["graph_breaks"] == 0 and stats["segments"] >= 1, stats


# ---------------------------------------------------------------------------
# eager
# ---------------------------------------------------------------------------

def test_cond_eager_picks_branch():
    x, y = t([2.0]), tt([2.0])
    for p in (True, False):
        want = jnn.cond(pt.to_tensor(p), lambda: x * 2, lambda: x - 1)
        got = snn.cond(torch.tensor(p), lambda: y * 2, lambda: y - 1)
        _eq(got, want)


def test_cond_python_bool_shortcut():
    x, y = t([3.0]), tt([3.0])
    _eq(snn.cond(True, lambda: y + 1, lambda: y),
        jnn.cond(True, lambda: x + 1, lambda: x))


def test_cond_structure_output():
    x, y = t([1.0, 2.0]), tt([1.0, 2.0])
    wa, wb = jnn.cond(t([1.0]).sum() > 0, lambda: (x * 2, x + 1),
                      lambda: (x, x))
    ga, gb = snn.cond(tt([1.0]).sum() > 0, lambda: (y * 2, y + 1),
                      lambda: (y, y))
    _eq(ga, wa)
    _eq(gb, wb)


def test_while_loop_eager():
    def body(i, ten):
        return [i + 1, ten]

    wi, _ = jnn.while_loop(lambda i, ten: (i < ten).all(), body,
                           [pt.to_tensor(np.asarray([0], np.int64)),
                            pt.to_tensor(np.asarray([10], np.int64))])
    gi, gten = snn.while_loop(lambda i, ten: (i < ten).all(), body,
                              [torch.tensor([0]), torch.tensor([10])])
    _eq(gi, wi)
    assert int(gi[0]) == 10 and int(gten[0]) == 10


def test_while_loop_captured_tensor():
    jstep = pt.to_tensor(np.asarray([2], np.int64), stop_gradient=True)
    (wi,) = jnn.while_loop(lambda i: (i < 9).all(), lambda i: [i + jstep],
                           [pt.to_tensor(np.asarray([0], np.int64))])
    step = torch.tensor([2])
    (gi,) = snn.while_loop(lambda i: (i < 9).all(), lambda i: [i + step],
                           [torch.tensor([0])])
    _eq(gi, wi)
    assert int(gi[0]) == 10


def test_case_first_true_wins():
    x, y = t([1.0]), tt([1.0])

    def both(m, v, tests):
        return m.case([(test(v), lambda k=k: v + k) for test, k in tests],
                      default=lambda: v - 7)

    for tests in ([(lambda v: (v > 0).all(), 10),
                   (lambda v: (v > -5).all(), 100)],
                  [(lambda v: (v > 5).all(), 10),
                   (lambda v: (v > 0).all(), 100)],
                  [(lambda v: (v > 5).all(), 10)]):
        _eq(both(snn, y, tests), both(jnn, x, tests))


def test_switch_case_by_index_and_default():
    x, y = t([1.0]), tt([1.0])
    for bi in (0, 1, 2, 7):
        want = jnn.switch_case(pt.to_tensor(np.asarray(bi, np.int32)),
                               [lambda: x * 1, lambda: x * 2, lambda: x * 3])
        got = snn.switch_case(torch.tensor(bi, dtype=torch.int32),
                              [lambda: y * 1, lambda: y * 2, lambda: y * 3])
        _eq(got, want)
    want = jnn.switch_case(pt.to_tensor(np.asarray(5, np.int32)),
                           [(1, lambda: x * 2), (3, lambda: x * 4)],
                           default=lambda: x - 1)
    got = snn.switch_case(torch.tensor(5, dtype=torch.int32),
                          [(1, lambda: y * 2), (3, lambda: y * 4)],
                          default=lambda: y - 1)
    _eq(got, want)
    assert float(got.detach()) == 0.0


# ---------------------------------------------------------------------------
# gradients through the taken branch
# ---------------------------------------------------------------------------

def test_cond_grad_through_taken_branch():
    for v in (3.0, -3.0):
        x, y = t([v]), tt([v])
        jnn.cond((x > 0).all(), lambda: x * x,
                 lambda: x * 4).sum().backward()
        snn.cond((y > 0).all(), lambda: y * y,
                 lambda: y * 4).sum().backward()
        _eq(y.grad, x.grad)


def test_case_grad():
    x, y = t([2.0]), tt([2.0])
    jnn.case([((x > 10).all(), lambda: x * 2),
              ((x > 0).all(), lambda: x * x * x)],
             default=lambda: x).sum().backward()
    snn.case([((y > 10).all(), lambda: y * 2),
              ((y > 0).all(), lambda: y * y * y)],
             default=lambda: y).sum().backward()
    _eq(y.grad, x.grad)
    assert float(y.grad) == 12.0


def test_while_loop_grad_raises_with_guidance():
    x, y = t([1.0]), tt([1.0])
    with pytest.raises(ValueError, match="not differentiable"):
        jnn.while_loop(lambda v: (v < 10).all(), lambda v: [v * 2], [x])
    with pytest.raises(ValueError, match="not differentiable"):
        snn.while_loop(lambda v: (v < 10).all(), lambda v: [v * 2], [y])
    with pt.no_grad():
        (want,) = jnn.while_loop(lambda v: (v < 10).all(),
                                 lambda v: [v * 2], [x])
    with torch.no_grad():
        (got,) = snn.while_loop(lambda v: (v < 10).all(),
                                lambda v: [v * 2], [y])
    _eq(got, want)
    assert float(got) == 16.0


# ---------------------------------------------------------------------------
# to_static: one captured graph, the node inside it
# ---------------------------------------------------------------------------

def test_cond_under_to_static_single_module():
    @pt.jit.to_static(full_graph=True)
    def jf(x):
        return jnn.cond((x.sum() > 0).all(), lambda: x * 2, lambda: x - 1)

    @TJ.to_static(backend=BACKEND)
    def tf(x):
        return snn.cond((x.sum() > 0).all(), lambda: x * 2, lambda: x - 1)

    for v in ([1.0, 2.0], [-1.0, -2.0]):
        _eq(tf(tt(v, False)), jf(t(v)))
    _one_graph(tf)
    assert tf.graph_break_stats["segments"] == 1      # both signs, one graph
    assert "torch.ops.higher_order.cond" in tf.lower(tt([1.0, 2.0], False))
    assert not jf._fell_back


def test_while_loop_under_to_static_single_module():
    @pt.jit.to_static(full_graph=True)
    def jf(n):
        i = pt.to_tensor(np.asarray([0], np.int64))
        i_out, _ = jnn.while_loop(lambda i, n: (i < n).all(),
                                  lambda i, n: [i + 1, n], [i, n])
        return i_out

    @TJ.to_static(backend=BACKEND)
    def tf(n):
        i = torch.zeros(1, dtype=torch.int64)
        i_out, _ = snn.while_loop(lambda i, n: (i < n).all(),
                                  lambda i, n: [i + 1, n], [i, n])
        return i_out

    for v in (7, 3):
        _eq(tf(torch.tensor([v])),
            jf(pt.to_tensor(np.asarray([v], np.int64))))
    _one_graph(tf)
    assert tf.graph_break_stats["segments"] == 1
    assert "torch.ops.higher_order.while_loop" in tf.lower(
        torch.tensor([7]))
    assert not jf._fell_back


def test_switch_case_under_to_static():
    @pt.jit.to_static(full_graph=True)
    def jf(x, bi):
        return jnn.switch_case(bi, [lambda: x * 1, lambda: x * 2,
                                    lambda: x * 3])

    @TJ.to_static(backend=BACKEND)
    def tf(x, bi):
        return snn.switch_case(bi, [lambda: x * 1, lambda: x * 2,
                                    lambda: x * 3])

    for bi in (0, 1, 2, 5):
        want = jf(t([2.0]), pt.to_tensor(np.asarray(bi, np.int32)))
        _eq(tf(tt([2.0], False), torch.tensor(bi, dtype=torch.int32)), want)
    _one_graph(tf)
    assert tf.graph_break_stats["segments"] == 1
    assert not jf._fell_back


def test_case_accepts_python_bool_preds():
    x, y = t([2.0]), tt([2.0])
    want = jnn.case([(False, lambda: x * 10), (True, lambda: x + 1)],
                    default=lambda: x)
    got = snn.case([(False, lambda: y * 10), (True, lambda: y + 1)],
                   default=lambda: y)
    _eq(got, want)

    @TJ.to_static(backend=BACKEND)
    def tf(v):
        return snn.case([(False, lambda: v * 10), (True, lambda: v + 1)],
                        default=lambda: v)

    _eq(tf(tt([2.0], False)), want)
    _one_graph(tf)


# ---------------------------------------------------------------------------
# free variables: gradients reach them, captures read them live
# ---------------------------------------------------------------------------

def test_cond_lifts_tensor_in_nested_dict_of_lists():
    w = pt.to_tensor(np.asarray([2.0], np.float32), stop_gradient=False)
    cfg = {"outer": [1, {"inner": [w, "x"]}]}
    want = jnn.cond(t([1.0]).sum() > 0,
                    lambda: cfg["outer"][1]["inner"][0] * 3.0,
                    lambda: cfg["outer"][1]["inner"][0] * 5.0)
    want.sum().backward()
    tw = tt([2.0])
    tcfg = {"outer": [1, {"inner": [tw, "x"]}]}

    @TJ.to_static(backend=BACKEND)
    def tf(p):
        return snn.cond(p.sum() > 0,
                        lambda: tcfg["outer"][1]["inner"][0] * 3.0,
                        lambda: tcfg["outer"][1]["inner"][0] * 5.0)

    got = tf(tt([1.0], False))
    got.sum().backward()
    _one_graph(tf)
    _eq(got, want)
    _eq(tw.grad, w.grad)


def test_cond_lifts_tensor_on_plain_object_attribute():
    class Holder:
        def __init__(self, v):
            self.v = v

    w = pt.to_tensor(np.asarray([4.0], np.float32), stop_gradient=False)
    h = Holder(w)
    jnn.cond(t([1.0]).sum() > 0, lambda: h.v * 2.0,
             lambda: h.v * 7.0).sum().backward()
    th = Holder(tt([4.0]))
    for cond in (snn.cond, TJ.to_static(snn.cond, backend=BACKEND)):
        th.v.grad = None
        cond(tt([1.0], False).sum() > 0, lambda: th.v * 2.0,
             lambda: th.v * 7.0).sum().backward()
        _eq(th.v.grad, w.grad)


def test_cond_lifts_tensor_through_helper_closure():
    w = pt.to_tensor(np.asarray([3.0], np.float32), stop_gradient=False)
    want = jnn.cond(t([1.0]).sum() > 0, lambda: w * 2.0 + 1.0,
                    lambda: w * 2.0 - 1.0)
    want.sum().backward()
    tw = tt([3.0])

    def helper():
        return tw * 2.0

    @TJ.to_static(backend=BACKEND)
    def tf(p):
        return snn.cond(p.sum() > 0, lambda: helper() + 1.0,
                        lambda: helper() - 1.0)

    got = tf(tt([1.0], False))
    got.sum().backward()
    _one_graph(tf)
    _eq(got, want)
    _eq(tw.grad, w.grad)


def test_to_static_cond_deep_closure_not_baked():
    """A free variable of a captured branch is read live: after the
    tensor is updated in place, the same captured program sees the new
    value."""
    w = pt.to_tensor(np.asarray([2.0], np.float32), stop_gradient=False)
    cfg = {"k": [[w]]}

    @pt.jit.to_static
    def jf(x):
        return jnn.cond(x.sum() > 0, lambda: cfg["k"][0][0] * x,
                        lambda: cfg["k"][0][0])

    tw = tt([2.0])
    tcfg = {"k": [[tw]]}

    @TJ.to_static(backend=BACKEND)
    def tf(x):
        return snn.cond(x.sum() > 0, lambda: tcfg["k"][0][0] * x,
                        lambda: tcfg["k"][0][0] * 1.0)

    _eq(tf(tt([3.0], False)), jf(t([3.0])))
    w._data = w._data * 10.0
    with torch.no_grad():
        tw.mul_(10.0)
    _eq(tf(tt([3.0], False)), jf(t([3.0])))
    assert float(tf(tt([3.0], False))) == 60.0
    assert tf.graph_break_stats["segments"] == 1


# ---------------------------------------------------------------------------
# the rest of static
# ---------------------------------------------------------------------------

def test_data_and_input_spec():
    want = JS.data("x", [None, 3], "float32")
    got = TS.data("x", [None, 3], "float32")
    assert isinstance(got, TS.InputSpec) and got.shape == want.shape
    assert got.name == want.name == "x"
    assert TS.InputSpec is TJ.InputSpec


@pytest.mark.parametrize("name", ["Program", "Executor",
                                  "default_main_program",
                                  "default_startup_program"])
def test_programs_raise_as_in_jax(name):
    with pytest.raises(NotImplementedError):
        getattr(JS, name)()
    with pytest.raises(NotImplementedError, match="jit"):
        getattr(TS, name)()


def test_inference_model_io_raises_with_the_ports_guidance():
    for fn in (JS.save_inference_model, TS.save_inference_model):
        with pytest.raises(NotImplementedError, match="jit.save"):
            fn("m", [], [])
    for fn in (JS.load_inference_model, TS.load_inference_model):
        with pytest.raises(NotImplementedError, match="create_predictor"):
            fn("m")
    with pytest.raises(NotImplementedError, match="paddle_tpu_torch.jit"):
        TS.save(None, "m")
    with pytest.raises(NotImplementedError, match="paddle_tpu_torch.jit"):
        TS.load(None, "m")


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_and_auc_match_jax(k):
    rs = np.random.RandomState(k)
    logits = rs.randn(12, 5).astype(np.float32)
    logits[3, :2] = 0.5                                   # a tie
    label = rs.randint(0, 5, (12, 1)).astype(np.int64)
    want = JS.accuracy(pt.to_tensor(logits), pt.to_tensor(label), k=k)
    got = TS.accuracy(torch.from_numpy(logits), torch.from_numpy(label), k=k)
    assert got.dtype == torch.float32
    # the hit count equal; the mean's f32 division may differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6)
    score = rs.rand(20, 2).astype(np.float32)
    lab = rs.randint(0, 2, (20,)).astype(np.int64)
    want = JS.auc(pt.to_tensor(score), pt.to_tensor(lab))
    got = TS.auc(torch.from_numpy(score), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6)


def test_places_guards_scope_and_global_var():
    assert TS.cpu_places(2) == [torch.device("cpu")] * 2
    places = TS.cuda_places()
    assert places and all(isinstance(p, torch.device) for p in places)
    with TS.device_guard("cpu"):
        assert torch.zeros(1).device.type == "cpu"
    with TS.program_guard(None), TS.scope_guard(None), TS.name_scope("a"):
        v = TS.create_global_var([2, 3], 1.5, "float32", name="gv19",
                                 device="cpu")
    want = JS.create_global_var([2, 3], 1.5, "float32", name="gv19")
    np.testing.assert_array_equal(v.numpy(), np.asarray(want.numpy()))
    assert TS.global_scope().find_var("gv19") is v


def test_static_tensors_go_to_the_card_unless_placed():
    """``create_global_var`` / ``create_parameter`` resolve their device
    as every entry point of the port does: the card by default, the CPU
    only when forced, named or guarded."""
    for make in (lambda **kw: TS.create_global_var([2], 0.5, "float32",
                                                   **kw),
                 lambda **kw: TS.create_parameter([2, 3], "float32", **kw)):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        with TS.device_guard("cpu"):
            assert make().device.type == "cpu"
        assert make(device="cpu").device.type == "cpu"
    v = TS.create_global_var([2], 0.5, "float32", force_cpu=True)
    assert v.device.type == "cpu"
    assert not TS._GUARDED


def test_gradients_append_backward_and_helpers():
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = torch.tensor([3.0], requires_grad=True)
    (gx, gy) = TS.gradients([(x * x).sum()], [x, y])
    assert gy is None and torch.equal(gx, 2 * x.detach())
    loss = (x * 3).sum()
    (p, g), = TS.append_backward(loss, parameter_list=[x])
    assert p is x and torch.equal(g, torch.full((2,), 3.0))
    assert TS.py_func(lambda a, b: a + b, [x, x], None).shape == (2,)
    assert TS.Print(x, message="x") is x
    w = TS.create_parameter([4, 6], "float32", device="cpu")
    b = TS.create_parameter([6], "float32", is_bias=True, device="cpu")
    assert isinstance(w, torch.nn.Parameter) and w.requires_grad
    assert torch.equal(b, torch.zeros(6))
    assert 0.2 < float(w.std()) / np.sqrt(2.0 / 10) < 3.0
    attr = TS.WeightNormParamAttr(dim=0, name="w")
    assert attr.dim == 0 and attr.trainable


def test_exponential_moving_average_matches_jax():
    jp = pt.to_tensor(np.asarray([1.0, 2.0], np.float32),
                      stop_gradient=False)
    tp = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    jema, tema = JS.ExponentialMovingAverage(0.9), \
        TS.ExponentialMovingAverage(0.9)
    for step in range(3):
        jema.update([jp])
        tema.update([tp])
        jp._data = jp._data + 1.0
        with torch.no_grad():
            tp.add_(1.0)
    with jema.apply(), tema.apply():
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp.numpy()), rtol=1e-6)
    np.testing.assert_array_equal(tp.detach().numpy(), [4.0, 5.0])
