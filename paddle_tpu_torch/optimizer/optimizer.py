"""Optimizers: ``paddle_tpu/optimizer/optimizer.py``, every class.

The Paddle protocol over torch parameters: ``step()`` updates every
parameter that has a ``.grad`` in place, ``clear_grad(set_to_zero)``
drops the gradients (or zeros them), ``state_dict()`` /
``set_state_dict()`` carry the slots, the step count and the scheduler.
``step()`` leaves the gradients where they are, as in the JAX package.

The JAX package's arithmetic and state, formula for formula:

* the learning rate is a 0-d f32 tensor (``_lr``, on the host: a CPU
  scalar in the device's arithmetic, so reading it never waits for the
  card), set from the scheduler at each ``step``;
* one global ``_step_count``, counted on every ``step`` even when no
  parameter has a gradient; Adam's ``t`` is that count in f32;
* the slots (``_accumulators[slot][id(p)]``) are f32 for the adaptive
  methods, the parameter's dtype (and memory format) for SGD momentum;
  under ``multi_precision`` a bf16 or f16 parameter gets an f32 master
  weight (slot ``master_weight``) that every update reads and writes,
  the parameter receiving its rounded copy;
* weight decay: ``L2Decay`` / a float adds ``wd · w`` to the gradient
  (Adam too); AdamW subtracts ``lr · wd · w`` after the update, and asks
  ``apply_decay_param_fun(name)`` first;
* ``grad_clip`` acts on the ``(param, grad)`` list before the updates.

Names: a parameter's name is its ``named_parameters()`` name when the
optimizer is given ``(name, tensor)`` pairs, else ``param_{i}`` (its
place in the list). ``state_dict`` keys are ``{name}_{slot}``;
``set_state_dict`` restores a slot whether or not a step made it yet
(the JAX package restores only slots a step already made).

Arguments the JAX classes accept and ignore: ``lazy_mode``,
``use_multi_tensor`` and ``name`` are accepted; ``amsgrad=True`` raises,
as it would change the arithmetic that was asked for.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "L1Decay", "L2Decay", "SGD", "Momentum", "Adam",
           "AdamW", "Adagrad", "RMSProp", "Adamax", "Lamb", "Adadelta",
           "ASGD", "Rprop", "NAdam", "RAdam"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


class Optimizer:
    _slot_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError(
                "parameters must be given (there is no global parameter "
                "registry); pass model.parameters()")
        items = list(parameters)
        if items and isinstance(items[0], dict):   # param groups, flattened
            items = [p for g in items for p in g["params"]]
        self._param_list: List[torch.Tensor] = []
        self._names: List[str] = []
        for i, it in enumerate(items):
            name_i, p = it if isinstance(it, tuple) else (f"param_{i}", it)
            self._param_list.append(p)
            self._names.append(name_i)
        self._lr_sched = (learning_rate if isinstance(learning_rate,
                                                      LRScheduler) else None)
        init_lr = learning_rate() if self._lr_sched else float(learning_rate)
        self._lr = _f32(init_lr)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_sched is not None:
            return self._lr_sched()
        return float(self._lr)

    def set_lr(self, value):
        self._lr_sched = None
        self._lr.fill_(float(value))

    def set_lr_scheduler(self, scheduler):
        self._lr_sched = scheduler

    def _sync_lr(self):
        if self._lr_sched is not None:
            self._lr.fill_(float(self._lr_sched()))

    # -- state --------------------------------------------------------------
    def _acc(self, name: str, p: torch.Tensor, init=None,
             dtype=None) -> torch.Tensor:
        store = self._accumulators.setdefault(name, {})
        key = id(p)
        if key not in store:
            if init is None:
                dt = dtype or (torch.float32 if self._use_master(p)
                               else p.dtype)
                store[key] = torch.zeros_like(p, dtype=dt)
            else:
                store[key] = torch.full_like(p, init, dtype=torch.float32)
        return store[key]

    def _use_master(self, p) -> bool:
        return self._multi_precision and p.dtype in _LOW_PRECISION

    def _master(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        if not self._use_master(p):
            return None
        store = self._accumulators.setdefault("master_weight", {})
        if id(p) not in store:
            store[id(p)] = p.detach().float()
        return store[id(p)]

    def _id2name(self) -> dict:
        return {id(p): n for p, n in zip(self._param_list, self._names)}

    def state_dict(self):
        out = {"LR_Scheduler": (self._lr_sched.state_dict()
                                if self._lr_sched else {"lr": self.get_lr()}),
               "step_count": self._step_count}
        id2name = self._id2name()
        for slot, store in self._accumulators.items():
            for pid, t in store.items():
                if pid in id2name:
                    out[f"{id2name[pid]}_{slot}"] = t
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        slots = list(self._slot_names) + ["master_weight"]
        for p, name in zip(self._param_list, self._names):
            for slot in slots:
                v = state.get(f"{name}_{slot}")
                if v is None:
                    continue
                v = torch.as_tensor(v)
                store = self._accumulators.setdefault(slot, {})
                if id(p) not in store:   # in p's memory format, as _acc
                    store[id(p)] = (
                        torch.empty_like(p, dtype=v.dtype)
                        if v.shape == p.shape else
                        torch.empty(v.shape, dtype=v.dtype, device=p.device))
                store[id(p)].copy_(v)
        if "LR_Scheduler" in state and self._lr_sched is not None:
            self._lr_sched.set_state_dict(state["LR_Scheduler"])
        if "step_count" in state:
            self._step_count = int(state["step_count"])

    # -- stepping -----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        self._sync_lr()
        params_grads = [(p, p.grad) for p in self._param_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            clipped = self._grad_clip(params_grads)
            params_grads = [(p, g) for (p, _), (_, g) in
                            zip(params_grads, clipped)]
        self._step_count += 1
        lr = self._lr
        for p, g in params_grads:
            self._apply_one(p, g, lr, self._master(p), self._decay_coeff(p))

    def _t(self) -> torch.Tensor:
        """The step count as a 0-d f32 (Adam's ``t``)."""
        return _f32(self._step_count)

    def _decay_coeff(self, p) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        if isinstance(wd, (L2Decay, L1Decay)):
            return wd.coeff
        return float(wd)

    def _apply_one(self, p, g, lr, master, wd):
        raise NotImplementedError

    @torch.no_grad()
    def clear_grad(self, set_to_zero: bool = False):
        for p in self._param_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    @staticmethod
    def _param_update(p, master, new_value_f32):
        """Write an update back into (master, param), rounding to the
        parameter's dtype."""
        if master is not None:
            master.copy_(new_value_f32)
        p.copy_(new_value_f32)

    @staticmethod
    def _weight(p, master) -> torch.Tensor:
        return (master if master is not None else p).float()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply_one(self, p, g, lr, master, wd):
        w = master if master is not None else p
        g = g.to(w.dtype)
        if wd:
            g = g + wd * w
        self._param_update(p, master, w - lr.to(w.dtype) * g)


class Momentum(Optimizer):
    """``v ← μ·v + g``, ``w ← w − lr·v`` (Nesterov: ``w − lr·(g + μ·v)``),
    each product rounded before its sum; ``v`` starts at zeros in w's
    dtype and memory format. The common case (no master weight) updates
    ``v`` and ``w`` in place."""

    _slot_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _apply_one(self, p, g, lr, master, wd):
        w = master if master is not None else p
        g = g.to(w.dtype)
        if wd:
            g = g + wd * w
        v = self._acc("velocity", p)
        v.mul_(self._momentum).add_(g)
        upd = g + self._momentum * v if self._nesterov else v
        if master is None:
            p.sub_(upd * lr.to(w.dtype))
        else:
            self._param_update(p, master, w - lr * upd)


class Adam(Optimizer):
    _slot_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        if amsgrad:
            raise NotImplementedError(
                "amsgrad=True is not implemented (the JAX package ignores "
                "it); it would change the update that was asked for")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._decoupled_wd = False  # Adam couples decay into grads (L2)

    def _apply_one(self, p, g, lr, master, wd):
        w32 = self._weight(p, master)
        g32 = g.float()
        if wd and not self._decoupled_wd:
            g32 = g32 + wd * w32
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        t = self._t()
        m.copy_(self._beta1 * m + (1 - self._beta1) * g32)
        v.copy_(self._beta2 * v + (1 - self._beta2) * torch.square(g32))
        mhat = m / (1 - torch.pow(self._beta1, t))
        vhat = v / (1 - torch.pow(self._beta2, t))
        new_w = w32 - lr * mhat / (torch.sqrt(vhat) + self._eps)
        if wd and self._decoupled_wd:
            new_w = new_w - lr * wd * w32
        self._param_update(p, master, new_w)


class AdamW(Adam):
    """Decoupled weight decay (reference: python/paddle/optimizer/adamw.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name=name)
        self._decoupled_wd = True
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, p):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(self._id2name()[id(p)])):
            return 0.0
        return super()._decay_coeff(p)


class Adagrad(Optimizer):
    _slot_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _apply_one(self, p, g, lr, master, wd):
        w32 = self._weight(p, master)
        g32 = g.float()
        if wd:
            g32 = g32 + wd * w32
        acc = self._acc("moment", p, init=self._init_acc)
        acc.copy_(acc + torch.square(g32))
        new_w = w32 - lr * g32 / (torch.sqrt(acc) + self._eps)
        self._param_update(p, master, new_w)


class RMSProp(Optimizer):
    _slot_names = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._eps = epsilon
        self._momentum = momentum
        self._centered = centered

    def _apply_one(self, p, g, lr, master, wd):
        w32 = self._weight(p, master)
        g32 = g.float()
        if wd:
            g32 = g32 + wd * w32
        ms = self._acc("mean_square", p, dtype=torch.float32)
        ms.copy_(self._rho * ms + (1 - self._rho) * torch.square(g32))
        if self._centered:
            mg = self._acc("mean_grad", p, dtype=torch.float32)
            mg.copy_(self._rho * mg + (1 - self._rho) * g32)
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        upd = lr * g32 / denom
        if self._momentum:
            mom = self._acc("momentum", p, dtype=torch.float32)
            mom.copy_(self._momentum * mom + upd)
            upd = mom
        self._param_update(p, master, w32 - upd)


class Adamax(Optimizer):
    _slot_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _apply_one(self, p, g, lr, master, wd):
        w32 = self._weight(p, master)
        g32 = g.float()
        if wd:
            g32 = g32 + wd * w32
        m = self._acc("moment", p, dtype=torch.float32)
        u = self._acc("inf_norm", p, dtype=torch.float32)
        t = self._t()
        m.copy_(self._beta1 * m + (1 - self._beta1) * g32)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(g32)))
        lr32 = lr / (1 - torch.pow(self._beta1, t))
        self._param_update(p, master, w32 - lr32 * m / (u + self._eps))


class Lamb(Optimizer):
    _slot_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, p, g, lr, master, wd):
        w32 = self._weight(p, master)
        g32 = g.float()
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        t = self._t()
        m.copy_(self._beta1 * m + (1 - self._beta1) * g32)
        v.copy_(self._beta2 * v + (1 - self._beta2) * torch.square(g32))
        mhat = m / (1 - torch.pow(self._beta1, t))
        vhat = v / (1 - torch.pow(self._beta2, t))
        r = mhat / (torch.sqrt(vhat) + self._eps)
        if wd and not (self._exclude_fn and self._exclude_fn(p)):
            r = r + wd * w32
        w_norm = torch.linalg.vector_norm(w32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        self._param_update(p, master, w32 - lr * trust * r)


class Adadelta(Optimizer):
    """reference python/paddle/optimizer/adadelta.py."""

    _slot_names = ["_avg_squared_grad", "_avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._eps = epsilon
        self._rho = rho

    def _apply_one(self, p, g, lr, master, wd):
        w = self._weight(p, master)
        g = g.float()
        if wd:
            g = g + wd * w
        avg_sq = self._acc("_avg_squared_grad", p, dtype=torch.float32)
        avg_up = self._acc("_avg_squared_update", p, dtype=torch.float32)
        avg_sq.copy_(self._rho * avg_sq + (1 - self._rho) * g * g)
        upd = (torch.sqrt(avg_up + self._eps)
               / torch.sqrt(avg_sq + self._eps)) * g
        avg_up.copy_(self._rho * avg_up + (1 - self._rho) * upd * upd)
        self._param_update(p, master, w - lr * upd)


class ASGD(Optimizer):
    """Averaged SGD (reference python/paddle/optimizer/asgd.py), as the
    JAX package writes it: ``d ← d − d/n + g``, ``w ← w − lr·d/n``."""

    _slot_names = ["_d"]

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._n = max(int(batch_num), 1)

    def _apply_one(self, p, g, lr, master, wd):
        w = self._weight(p, master)
        g = g.float()
        if wd:
            g = g + wd * w
        d = self._acc("_d", p, dtype=torch.float32)
        d.copy_(d - d / self._n + g)
        self._param_update(p, master, w - lr * d / self._n)


class Rprop(Optimizer):
    """Resilient backprop (reference python/paddle/optimizer/rprop.py):
    per-weight step sizes adapted by grad sign agreement."""

    _slot_names = ["_prev_grad", "_step_size"]

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_lo, self._lr_hi = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_lr = float(learning_rate) if not isinstance(
            learning_rate, LRScheduler) else learning_rate()

    def _apply_one(self, p, g, lr, master, wd):
        w = self._weight(p, master)
        g = g.float()
        prev = self._acc("_prev_grad", p, dtype=torch.float32)
        steps = self._acc("_step_size", p, init=self._init_lr)
        sign = torch.sign(g * prev)
        factor = torch.where(
            sign > 0, torch.full_like(sign, self._eta_pos),
            torch.where(sign < 0, torch.full_like(sign, self._eta_neg),
                        torch.ones_like(sign)))
        steps.copy_(torch.clamp(steps * factor, self._lr_lo, self._lr_hi))
        # on sign flip: do not step, zero the remembered grad
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        prev.copy_(g_eff)
        self._param_update(p, master, w - steps * torch.sign(g_eff))


class NAdam(Adam):
    """Nesterov Adam (reference python/paddle/optimizer/nadam.py)."""

    _slot_names = ["_mu_product", "moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._psi = momentum_decay

    def _apply_one(self, p, g, lr, master, wd):
        w = self._weight(p, master)
        g = g.float()
        if wd:
            g = g + wd * w
        t = self._t()
        mu_t = self._beta1 * (1 - 0.5 * torch.pow(0.96, t * self._psi))
        mu_next = self._beta1 * (1 - 0.5 * torch.pow(0.96,
                                                     (t + 1) * self._psi))
        store = self._accumulators.setdefault("_mu_product", {})
        if id(p) not in store:
            store[id(p)] = torch.ones((), dtype=torch.float32,
                                      device=p.device)
        prod = store[id(p)]
        prod.copy_(prod * mu_t)
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g * g)
        mhat = (mu_next * m / (1 - prod * mu_next)
                + (1 - mu_t) * g / (1 - prod))
        vhat = v / (1 - torch.pow(self._beta2, t))
        self._param_update(
            p, master, w - lr * mhat / (torch.sqrt(vhat) + self._eps))


class RAdam(Adam):
    """Rectified Adam (reference python/paddle/optimizer/radam.py)."""

    def _apply_one(self, p, g, lr, master, wd):
        w = self._weight(p, master)
        g = g.float()
        if wd:
            g = g + wd * w
        t = self._t()
        m = self._acc("moment1", p, dtype=torch.float32)
        v = self._acc("moment2", p, dtype=torch.float32)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g * g)
        mhat = m / (1 - torch.pow(self._beta1, t))
        rho_inf = 2.0 / (1 - self._beta2) - 1
        rho_t = rho_inf - 2 * t * torch.pow(self._beta2, t) / (
            1 - torch.pow(self._beta2, t))
        # variance-rectified branch vs un-adapted (SGD-with-momentum); the
        # choice is one host scalar's, so one branch is computed
        if bool(rho_t > 5.0):
            r = torch.sqrt(torch.clamp_min(
                (rho_t - 4) * (rho_t - 2) * rho_inf
                / torch.clamp_min((rho_inf - 4) * (rho_inf - 2) * rho_t,
                                  1e-12), 0.0))
            vhat = torch.sqrt(v / (1 - torch.pow(self._beta2, t)))
            upd = r * mhat / (vhat + self._eps)
        else:
            upd = mhat
        self._param_update(p, master, w - lr * upd)
