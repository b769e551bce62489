"""The port's optimizers and LR schedulers against the JAX package's.

* every optimizer class (``SGD``, ``Momentum`` with and without
  Nesterov, ``Adam``, ``AdamW``, ``Adagrad``, ``RMSProp`` plain and
  centered with momentum, ``Adamax``, ``Lamb``, ``Adadelta``, ``ASGD``,
  ``Rprop``, ``NAdam``, ``RAdam`` in both of its branches): three steps
  on the same seeded f32 parameters and gradients, plain, with weight
  decay, with each gradient clip and under a scheduler; the parameters
  and every state slot within f32 ``rtol 1e-6`` / ``atol 1e-7`` of the
  JAX package's (the two libraries' ``pow``, ``sqrt`` and reductions may
  round an ulp apart);
* ``multi_precision`` on bf16 parameters: the f32 master weights within
  the same tolerance, each bf16 parameter its master rounded;
* ``state_dict`` / ``set_state_dict``: a fresh optimizer given the state
  takes the next step bitwise as the original does;
* every LR scheduler's 20-step sequence exactly equal to the JAX one's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import lr as JLR
from paddle_tpu_torch import nn as TNN
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.optimizer import lr as TLR

RTOL, ATOL = 1e-6, 1e-7
SHAPES = [(5, 3, 3, 3), (7,), (11, 4)]
STEPS = 3

# name: (class name, keyword arguments, weight-decay keyword or None)
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.1), "weight_decay"),
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9),
                 "weight_decay"),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True),
                          "weight_decay"),
    "adam": ("Adam", dict(learning_rate=0.01), "weight_decay"),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.0),
              "weight_decay"),
    "adagrad": ("Adagrad", dict(learning_rate=0.1,
                                initial_accumulator_value=0.1),
                "weight_decay"),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01), "weight_decay"),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, centered=True,
                                         momentum=0.9), "weight_decay"),
    "adamax": ("Adamax", dict(learning_rate=0.01), "weight_decay"),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.0),
             "lamb_weight_decay"),
    "adadelta": ("Adadelta", dict(learning_rate=1.0), "weight_decay"),
    "asgd": ("ASGD", dict(learning_rate=0.1, batch_num=3), "weight_decay"),
    "rprop": ("Rprop", dict(learning_rate=0.01), None),
    "nadam": ("NAdam", dict(learning_rate=0.01), "weight_decay"),
    "radam": ("RAdam", dict(learning_rate=0.01), "weight_decay"),
    # from step 100 on, RAdam takes its variance-rectified branch
    "radam_rectified": ("RAdam", dict(learning_rate=0.01), "weight_decay"),
}
START = {"radam_rectified": 100}
VARIANTS = ("plain", "decay", "clip_global", "clip_norm", "clip_value",
            "scheduled")


def _arrays(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    init = [rs.randn(*s).astype(dtype) for s in SHAPES]
    grads = [[rs.randn(*s).astype(dtype) for s in SHAPES]
             for _ in range(STEPS)]
    # some exact zeros (Rprop's sign, Adam's empty moments)
    grads[1][1][2] = 0.0
    return init, grads


def _clip(mod, variant):
    if variant == "clip_global":
        return mod.ClipGradByGlobalNorm(1.0)
    if variant == "clip_norm":
        return mod.ClipGradByNorm(0.5)
    if variant == "clip_value":
        return mod.ClipGradByValue(0.3)
    return None


def _sched(mod, variant):
    return mod.StepDecay(0.05, step_size=1, gamma=0.5)


def _kwargs(case, variant, nn_mod, lr_mod):
    _, kw, wd_key = CASES[case]
    kw = dict(kw)
    if variant == "decay":   # Rprop takes none (no such case)
        kw[wd_key] = 0.01
    clip = _clip(nn_mod, variant)
    if clip is not None:
        kw["grad_clip"] = clip
    if variant == "scheduled":
        kw["learning_rate"] = _sched(lr_mod, variant)
    return kw


def run_jax(case, variant, init, grads, dtype="float32", **extra):
    kw = _kwargs(case, variant, pt.nn, JLR)
    kw.update(extra)
    params = [pt.create_parameter(p.shape, dtype) for p in init]
    for jp, p in zip(params, init):
        jp._data = jnp.asarray(p, dtype)
    opt = getattr(pt.optimizer, CASES[case][0])(parameters=params, **kw)
    if case in START:
        opt.set_state_dict({"step_count": START[case]})
    for g in grads:
        for jp, a in zip(params, g):
            jp._grad = Tensor(jnp.asarray(a, dtype))
        opt.step()
        opt.clear_grad()
        if variant == "scheduled":
            opt._lr_sched.step()
    slots = {slot: [np.asarray(store[id(p)]._data, np.float32)
                    for p in params if id(p) in store]
             for slot, store in opt._accumulators.items()}
    return [np.asarray(p._data.astype(jnp.float32)) for p in params], slots


def make_port(case, variant, init, dtype=torch.float32, **extra):
    kw = _kwargs(case, variant, TNN, TLR)
    kw.update(extra)
    params = [torch.from_numpy(p.copy()).to(dtype).requires_grad_()
              for p in init]
    opt = getattr(TO, CASES[case][0])(parameters=params, **kw)
    if case in START:
        opt.set_state_dict({"step_count": START[case]})
    return params, opt


def port_steps(params, opt, grads, variant, dtype=torch.float32):
    for g in grads:
        for tp, a in zip(params, g):
            tp.grad = torch.from_numpy(a.copy()).to(dtype)
        opt.step()
        assert all(tp.grad is not None for tp in params)
        opt.clear_grad()
        if variant == "scheduled":
            opt._lr_sched.step()


def run_port(case, variant, init, grads):
    params, opt = make_port(case, variant, init)
    port_steps(params, opt, grads, variant)
    slots = {slot: [store[id(p)].float().numpy() for p in params
                    if id(p) in store]
             for slot, store in opt._accumulators.items()}
    return [p.detach().numpy() for p in params], slots, opt


@pytest.mark.parametrize("case,variant", [
    (c, v) for c in sorted(CASES) for v in VARIANTS
    if not (v == "decay" and CASES[c][2] is None)])
def test_optimizer_matches_jax(case, variant):
    init, grads = _arrays(sorted(CASES).index(case))
    jp, jslots = run_jax(case, variant, init, grads)
    tp, tslots, opt = run_port(case, variant, init, grads)
    assert opt._step_count == STEPS + START.get(case, 0)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert sorted(tslots) == sorted(jslots)
    for slot in jslots:
        assert len(tslots[slot]) == len(jslots[slot]), slot
        for a, b in zip(tslots[slot], jslots[slot]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=slot)
    # the update moved every parameter
    for a, p0 in zip(tp, init):
        assert not np.array_equal(a, p0)


@pytest.mark.parametrize("case", ["sgd", "momentum", "adam", "adamw",
                                  "lamb"])
def test_multi_precision_masters_match_jax(case):
    """bf16 parameters and gradients under ``multi_precision``: the f32
    masters within f32 tolerance of JAX's; each bf16 parameter is its
    master rounded to bf16."""
    init, grads = _arrays(40)
    jp, jslots = run_jax(case, "decay", init, grads, dtype="bfloat16",
                         multi_precision=True)
    params, opt = make_port(case, "decay", init, dtype=torch.bfloat16,
                            multi_precision=True)
    port_steps(params, opt, grads, "decay", dtype=torch.bfloat16)
    masters = opt._accumulators["master_weight"]
    for p, jm in zip(params, jslots["master_weight"]):
        m = masters[id(p)]
        assert m.dtype == torch.float32 and p.dtype == torch.bfloat16
        np.testing.assert_allclose(m.numpy(), jm, rtol=RTOL, atol=ATOL)
        assert torch.equal(p.detach(), m.to(torch.bfloat16))
    for slot, arrs in jslots.items():
        for p, a in zip(params, arrs):
            got = opt._accumulators[slot][id(p)]
            assert got.dtype == torch.float32, slot
            np.testing.assert_allclose(got.numpy(), a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["momentum", "adam", "nadam", "rprop"])
def test_state_dict_round_trip(case):
    """Two steps, ``state_dict`` into a fresh optimizer over copies of the
    parameters, then one more step on each: bitwise equal; keys are
    ``{name}_{slot}`` with the ``named_parameters()`` names."""
    init, grads = _arrays(50)
    net = torch.nn.Linear(4, 3)
    names = [n for n, _ in net.named_parameters()]
    params, opt = make_port(case, "scheduled", init)
    port_steps(params, opt, grads[:2], "scheduled")
    state = opt.state_dict()
    params2 = [p.detach().clone().requires_grad_() for p in params]
    opt2 = type(opt)(parameters=params2,
                     **_kwargs(case, "scheduled", TNN, TLR))
    opt2.set_state_dict(state)
    assert opt2._step_count == opt._step_count == 2
    assert opt2._lr_sched.last_epoch == opt._lr_sched.last_epoch
    port_steps(params, opt, grads[2:], "scheduled")
    port_steps(params2, opt2, grads[2:], "scheduled")
    for a, b in zip(params, params2):
        assert torch.equal(a, b)
    named = getattr(TO, CASES[case][0])(
        parameters=list(net.named_parameters()),
        **_kwargs(case, "plain", TNN, TLR))
    for _, p in net.named_parameters():
        p.grad = torch.ones_like(p)
    named.step()
    keys = {k for k in named.state_dict() if k not in ("LR_Scheduler",
                                                       "step_count")}
    assert keys == {f"{n}_{s}" for n in names
                    for s in named._accumulators}


def test_amsgrad_raises_and_ignored_arguments_pass():
    p = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(NotImplementedError, match="amsgrad"):
        TO.Adam(parameters=p, amsgrad=True)
    TO.Adam(parameters=p, lazy_mode=True, use_multi_tensor=True, name="a")


def test_adamw_apply_decay_param_fun_gets_names():
    """``apply_decay_param_fun`` is called with each parameter's name; the
    ones it refuses are not decayed (their update equals Adam's)."""
    net = torch.nn.Linear(4, 3)
    seen = []

    def fn(name):
        seen.append(name)
        return name.endswith("weight")

    opt = TO.AdamW(learning_rate=0.1, weight_decay=0.5,
                   parameters=list(net.named_parameters()),
                   apply_decay_param_fun=fn)
    ref = torch.nn.Linear(4, 3)
    ref.load_state_dict(net.state_dict())
    ref_opt = TO.Adam(learning_rate=0.1, parameters=ref.parameters())
    for m in (net, ref):
        for p in m.parameters():
            p.grad = torch.ones_like(p)
    opt.step()
    ref_opt.step()
    assert sorted(set(seen)) == ["bias", "weight"]
    assert torch.equal(net.bias, ref.bias)
    assert not torch.equal(net.weight, ref.weight)


def test_step_counts_without_gradients_and_set_lr():
    p = torch.zeros(3, requires_grad=True)
    opt = TO.SGD(learning_rate=0.5, parameters=[p])
    opt.step()
    assert opt._step_count == 1 and torch.equal(p, torch.zeros(3))
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and opt._lr.dtype == torch.float32
    p.grad = torch.ones(3)
    opt.clear_grad(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(3))


# --------------------------------------------------------------------------
# LR schedulers
# --------------------------------------------------------------------------

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5),
    "piecewise": lambda m: m.PiecewiseDecay([3, 8], [0.1, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                              power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.1, decay_steps=7,
                                                    cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.1, warmup_steps=5,
                                              start_lr=0.0, end_lr=0.1),
    "linear_warmup_sched": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=10), warmup_steps=4,
        start_lr=0.01, end_lr=0.1),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 15]),
    "step": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.7),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(
        0.1, patience=2, cooldown=1, factor=0.5),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=12, eta_min=0.001),
    "cosine_warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=15),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, step_size_down=5, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode="exp_range", exp_gamma=0.9),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=8),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1,
                                                      lambda e: 0.9),
}
# losses fed to ReduceOnPlateau: down, then a plateau
PLATEAU = [1.0, 0.9, 0.8, 0.8, 0.8, 0.8, 0.79, 0.8, 0.8, 0.8] * 2


def _sequence(sched, name):
    out = []
    for i in range(20):
        out.append(sched())
        if name == "reduce_on_plateau":
            sched.step(PLATEAU[i])
        else:
            sched.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_equals_jax(name):
    got = _sequence(SCHEDULERS[name](TLR), name)
    want = _sequence(SCHEDULERS[name](JLR), name)
    assert got == want
    assert len(set(got)) > 1, "the sequence never moved"


def test_scheduler_state_round_trip():
    s = TLR.CosineAnnealingWarmRestarts(0.1, T_0=3, T_mult=2)
    for _ in range(5):
        s.step()
    t = TLR.CosineAnnealingWarmRestarts(0.1, T_0=3, T_mult=2)
    t.set_state_dict(s.state_dict())
    assert t() == s() and t.last_epoch == 5
    s.step()
    t.step()
    assert t() == s()
