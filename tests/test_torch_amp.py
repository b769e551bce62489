"""The rest of the port's ``amp`` and ``core.flags`` vs the JAX package's:
``GradScaler``, O2 ``decorate``, ``debugging``.

The models are tiny MLPs and a conv-BN-LayerNorm stack whose weights
come from the JAX model (``params_from_jax``); inputs are seeded numpy.

Contract: the scaler's scale, good and bad counters, ``state_dict`` and
found-inf decision equal JAX's exactly at every step through a seeded
inf (``scale`` -> ``backward`` -> ``step`` -> ``update``, and
``minimize``), the parameters within the optimizers' rtol 1e-6;
``decorate``'s per-parameter dtypes, its return values and the
optimizers' ``_multi_precision`` equal JAX's; 3 O2 Momentum steps keep
the parameters within 1 bf16 ulp of JAX's and the f32 masters within
rtol 1e-6; ``check_numerics``' counts and the tensor checker act as on
``tests/test_profiler_debugging.py``'s cases; ``core.flags`` gets, sets
(strings parsed by type), reads the environment and raises
``ValueError`` as the JAX registry does. Port only: ``unscale_`` then
``step`` divides once (the JAX ``step`` divides again); the flag reaches
another thread through ``sync_thread``.
"""
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.amp import debugging as JD
from paddle_tpu.core import flags as JF
from paddle_tpu_torch import amp as TA
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.amp import debugging as TD
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.models import _layers as L
from paddle_tpu_torch.models.llama import params_from_jax

RTOL = 1e-6


def _pair(seed=0):
    pt.seed(seed)
    jm = pt.nn.Sequential(pt.nn.Linear(4, 8), pt.nn.ReLU(),
                          pt.nn.Linear(8, 3))
    tm = nn.Sequential(L.Linear(4, 8), nn.ReLU(), L.Linear(8, 3))
    st = {k: np.array(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(params_from_jax(st, device="cpu"))
    return jm, tm


def _data(step):
    rs = np.random.RandomState(100 + step)
    return (rs.randn(5, 4).astype(np.float32),
            rs.randn(5, 3).astype(np.float32))


def _jloss(jm, x, y):
    d = jm(pt.to_tensor(x)) - pt.to_tensor(y)
    return (d * d).mean()


def _tloss(tm, x, y):
    d = tm(torch.from_numpy(x)) - torch.from_numpy(y)
    return (d * d).mean()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _scaler_state(s):
    return (s.get_loss_scaling(), s._good_steps, s._bad_steps,
            s._found_inf, s.state_dict())


def test_grad_scaler_matches_jax_through_a_seeded_inf():
    jm, tm = _pair()
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    js, ts = pt.amp.GradScaler(**kw), TA.GradScaler(**kw)
    jo = pt.optimizer.Momentum(0.1, 0.9, parameters=jm.parameters())
    to = TO.Momentum(0.1, 0.9, parameters=tm.parameters())
    for step in range(6):
        x, y = _data(step)
        js.scale(_jloss(jm, x, y)).backward()
        ts.scale(_tloss(tm, x, y)).backward()
        if step == 2:       # one element of one gradient overflows
            p = jm.parameters()[0]
            p._grad._data = p._grad._data.at[0, 0].set(jnp.inf)
            with torch.no_grad():
                tm[0].weight.grad[0, 0] = float("inf")
        js.step(jo)
        ts.step(to)
        js.update()
        ts.update()
        jo.clear_grad()
        to.clear_grad()
        assert _scaler_state(ts) == _scaler_state(js), step
        assert ts._found_inf == (step == 2)
    # two good steps double the scale; the inf halves it
    assert ts.get_loss_scaling() == 1024.0 * 2 / 2 * 2
    for jp, (_, tp) in zip(jm.parameters(), tm.named_parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._data),
                                   rtol=RTOL, atol=1e-7)
    # load_state_dict restores the scale and the counters, as JAX's does
    ts2, js2 = TA.GradScaler(**kw), pt.amp.GradScaler(**kw)
    ts2.load_state_dict(ts.state_dict())
    js2.load_state_dict(js.state_dict())
    assert ts2.state_dict() == js2.state_dict() == ts.state_dict()


def test_minimize_matches_jax():
    jm, tm = _pair(1)
    js, ts = pt.amp.GradScaler(incr_every_n_steps=1), \
        TA.GradScaler(incr_every_n_steps=1)
    jo = pt.optimizer.SGD(0.05, parameters=jm.parameters())
    to = TO.SGD(0.05, parameters=tm.parameters())
    for step in range(3):
        x, y = _data(step)
        js.minimize(jo, _jloss(jm, x, y))
        ts.minimize(to, _tloss(tm, x, y))
        assert _scaler_state(ts) == _scaler_state(js)
        assert all(p.grad is None for p in tm.parameters())
    for jp, (_, tp) in zip(jm.parameters(), tm.named_parameters()):
        np.testing.assert_allclose(tp.detach().numpy(), _f32(jp._data),
                                   rtol=RTOL, atol=1e-7)


def test_unscale_then_step_divides_once():
    _, tm = _pair(2)
    opt = TO.SGD(0.5, parameters=tm.parameters())
    sc = TA.GradScaler(init_loss_scaling=8.0)
    x, y = _data(0)
    w0 = tm[0].weight.detach().clone()
    sc.scale(_tloss(tm, x, y)).backward()
    scaled = tm[0].weight.grad.clone()
    sc.unscale_(opt)
    torch.testing.assert_close(tm[0].weight.grad, scaled / 8.0, rtol=0,
                               atol=0)
    sc.step(opt)                # must not divide again
    torch.testing.assert_close(tm[0].weight.detach(),
                               w0 - 0.5 * (scaled / 8.0), rtol=0, atol=0)
    assert not sc._unscaled


def _stacks():
    """A conv / BN / LayerNorm / Linear stack on both sides."""
    pt.seed(3)
    jm = pt.nn.Sequential(pt.nn.Conv2D(3, 4, 1), pt.nn.BatchNorm2D(4),
                          pt.nn.Flatten(), pt.nn.LayerNorm(16),
                          pt.nn.Linear(16, 2))
    tm = nn.Sequential(L.conv(3, 4, 1, bias=True), L.BatchNorm2D(4),
                       nn.Flatten(), nn.LayerNorm(16), L.Linear(16, 2))
    return jm, tm


def _dtypes(named):
    return [str(p.dtype).replace("torch.", "").replace("jnp.", "")
            for _, p in named]


@pytest.mark.parametrize("excluded", [None, "type", "instance"])
def test_decorate_dtypes_and_returns_match_jax(excluded):
    jm, tm = _stacks()
    ex = {None: (None, None), "type": (pt.nn.Linear, L.Linear),
          "instance": (jm[0], tm[0])}[excluded]
    jo = pt.optimizer.Momentum(0.1, parameters=jm.parameters())
    to = TO.Momentum(0.1, parameters=tm.parameters())
    jr = pt.amp.decorate(jm, jo, level="O2", excluded_layers=ex[0])
    tr = TA.decorate(tm, to, level="O2", excluded_layers=ex[1])
    assert tr[0] is tm and tr[1] is to and jr[0] is jm and jr[1] is jo
    jd = [str(p._data.dtype) for p in jm.parameters()]
    assert _dtypes(tm.named_parameters()) == jd
    assert to._multi_precision is jo._multi_precision is True
    # a list of models without optimizers comes back as a list
    jm2, tm2 = _stacks()
    assert TA.decorate([tm2], level="O2", master_weight=False) == [tm2]
    assert pt.amp.decorate([jm2], level="O2") == [jm2]
    # O1 decorates nothing
    jm3, tm3 = _stacks()
    jo3 = pt.optimizer.SGD(0.1, parameters=jm3.parameters())
    to3 = TO.SGD(0.1, parameters=tm3.parameters())
    pt.amp.decorate(jm3, jo3, level="O1")
    TA.decorate(tm3, to3, level="O1")
    assert _dtypes(tm3.named_parameters()) == \
        [str(p._data.dtype) for p in jm3.parameters()]
    assert to3._multi_precision is jo3._multi_precision is False


def test_o2_momentum_steps_match_jax():
    jm, tm = _pair(4)
    jo = pt.optimizer.Momentum(0.1, 0.9, parameters=jm.parameters())
    to = TO.Momentum(0.1, 0.9, parameters=tm.parameters())
    pt.amp.decorate(jm, jo, level="O2")
    TA.decorate(tm, to, level="O2")
    for step in range(3):
        x, y = _data(step)
        jl, tl = _jloss(jm, x, y), _tloss(tm, x, y)
        assert tl.dtype == torch.float32      # Linear promotes, as jnp
        jl.backward()
        tl.backward()
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
    for jp, tp in zip(jm.parameters(), tm.parameters()):
        assert tp.dtype == torch.bfloat16
        got, want = tp.detach().float().numpy(), _f32(jp._data)
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - want) <= ulp).all()
        jmaster = jo._accumulators["master_weight"][id(jp)]
        tmaster = to._accumulators["master_weight"][id(tp)]
        assert tmaster.dtype == torch.float32
        np.testing.assert_allclose(tmaster.numpy(), _f32(jmaster._data),
                                   rtol=RTOL, atol=1e-7)


def test_check_numerics_counts_and_abort_match_jax():
    a = np.array([1.0, np.nan, np.inf, 0.0, -np.inf, 0.0], np.float32)
    j = JD.check_numerics(pt.to_tensor(a),
                          debug_mode=JD.DebugMode.CHECK_ALL)
    t = TD.check_numerics(torch.from_numpy(a),
                          debug_mode=TD.DebugMode.CHECK_ALL)
    assert [int(v) for v in t] == [int(v) for v in j] == [1, 2, 2]
    for mod, arr in ((JD, pt.to_tensor(a)), (TD, torch.from_numpy(a))):
        with pytest.raises(FloatingPointError, match="op=mul var=x"):
            mod.check_numerics(arr, op_type="mul", var_name="x")


def test_tensor_checker_catches_nan_in_eager_op():
    cfg = TD.TensorCheckerConfig(enable=True)
    a = torch.tensor([1.0, 0.0])
    b = torch.tensor([0.0, 0.0])
    with TD.debug_guard(cfg):
        with pytest.raises(FloatingPointError, match="'div.Tensor'"):
            _ = a / b  # 1/0 = inf
        _ = a * b       # finite: no error
        torch.empty(4)  # allocations are not checked
    # disabled again outside the guard, as in the JAX package
    assert torch.isinf(a / b).any()
    jcfg = JD.TensorCheckerConfig(enable=True)
    with JD.debug_guard(jcfg):
        with pytest.raises(FloatingPointError):
            _ = pt.to_tensor(np.array([1.0], np.float32)) / pt.to_tensor(
                np.array([0.0], np.float32))
    assert TF.get_flags("check_nan_inf") == JF.get_flags("check_nan_inf") \
        == {"check_nan_inf": False}


def test_set_flags_reaches_another_thread():
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    errs = []
    started, flagged = threading.Event(), threading.Event()

    def worker():
        TD.sync_thread()
        errs.append(_get_current_dispatch_mode())   # flag off: no mode
        started.set()
        flagged.wait(10)
        TD.sync_thread()    # the engine's loop does this once a turn
        try:
            torch.tensor([1.0]) / torch.tensor([0.0])
        except FloatingPointError as e:
            errs.append(e)
        TF.set_flags({"FLAGS_check_nan_inf": False})
        TD.sync_thread()

    th = threading.Thread(target=worker)
    th.start()
    started.wait(10)
    TF.set_flags({"FLAGS_check_nan_inf": True})
    try:
        flagged.set()
        th.join(10)
    finally:
        TF.set_flags({"FLAGS_check_nan_inf": False})
    assert errs[0] is None and isinstance(errs[1], FloatingPointError)
    assert _get_current_dispatch_mode() is None


def test_flags_match_jax(monkeypatch):
    for mod in (JF, TF):
        assert mod.get_flags("FLAGS_check_nan_inf") == \
            {"FLAGS_check_nan_inf": False}
        with pytest.raises(ValueError, match="unknown flag"):
            mod.get_flags(["check_nan_inf", "no_such_flag"])
        with pytest.raises(ValueError, match="unknown flag"):
            mod.set_flags({"FLAGS_no_such_flag": 1})
        monkeypatch.setenv("FLAGS_port_parity_probe", "7")
        assert mod.define_flag("port_parity_probe", 3, "probe") == 7
        mod.set_flags({"port_parity_probe": "11"})
        assert mod.get_flag("port_parity_probe") == 11
        monkeypatch.setenv("FLAGS_port_parity_bool", "ON")
        assert mod.define_flag("port_parity_bool", False) is True
        mod.set_flags({"FLAGS_port_parity_bool": "no"})
        assert mod.get_flags(["FLAGS_port_parity_bool"]) == \
            {"FLAGS_port_parity_bool": False}
        assert {"port_parity_probe", "port_parity_bool",
                "check_nan_inf"} <= {f.name for f in mod.all_flags()}
