"""Gradient clipping: ``paddle_tpu/nn/clip.py``.

Each clip takes the ``(param, grad)`` list the optimizer passes (before
its updates) and returns the list with the gradients clipped:
``ClipGradByValue`` to ``[min, max]``; ``ClipGradByNorm`` scales each
gradient by ``min(clip_norm / max(‖g‖, 1e-12), 1)``;
``ClipGradByGlobalNorm`` scales every gradient by ``clip_norm /
max(‖(g …)‖, clip_norm)``, the global norm summed in f32 over the list
in its order, each gradient cast back to its dtype.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def _apply(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._apply(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _apply(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _apply(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def _apply(self, params_grads):
        sq = [torch.sum(torch.square(g.float()))
              for _, g in params_grads if g is not None]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(sum(sq))
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return [(p, None if g is None else (g * scale).to(g.dtype))
                for p, g in params_grads]
