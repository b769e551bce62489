"""GradScaler: ``paddle_tpu/amp/grad_scaler.py`` (reference:
python/paddle/amp/grad_scaler.py:62,645).

Dynamic loss scaling over an optimizer's ``_param_list`` and each
parameter's ``.grad``, with the JAX package's constants and rule:
``scale(loss)`` multiplies by the scale; ``unscale_(opt)`` multiplies
every gradient by ``1 / scale`` and finds whether one of them holds a
NaN or an Inf; ``step(opt)`` unscales (unless ``unscale_`` already did
since the last step) and steps the optimizer only when every gradient
is finite; ``update()`` halves the scale (``decr_ratio``, not below 1)
after ``decr_every_n_nan_or_inf`` bad steps in a row and doubles it
(``incr_ratio``) after ``incr_every_n_steps`` good ones, each counter
reset by the other kind of step.

``unscale_`` reads one flag back from the device for the whole gradient
set (the finiteness of every gradient is reduced on the device first),
as the JAX scaler does.

Where the port differs: ``unscale_(opt)`` then ``step(opt)`` divides
once, as Paddle does. The JAX ``step`` reads an ``_unscaled`` flag that
its ``unscale_`` never sets, so there the gradients are divided twice.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        grads = [p.grad for p in optimizer._param_list
                 if p.grad is not None]
        self._unscaled = True
        if not grads:
            self._found_inf = False
            return
        torch._foreach_mul_(grads, inv)
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        self._found_inf = not bool(finite.all())   # the one read-back

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, loss):
        scaled = self.scale(loss)
        scaled.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler
