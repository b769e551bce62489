"""DataParallel.

Port of ``paddle_tpu/distributed/parallel.py`` (reference:
``python/paddle/distributed/parallel.py:219``, the ``EagerReducer``'s
all-reduce hooks). The JAX wrapper shards a global batch over the
mesh's dp axis and lets GSPMD reduce; the port, one process a rank, is
Paddle's own: each rank feeds its own rows, and after backward each
parameter's gradient is all-reduced over the dp group and divided by
its size (a post-accumulate hook a parameter, in the order backward
reaches them), so every rank holds the gradient of the mean over all
ranks' rows. ``no_sync()`` defers that: gradients accumulate locally
and the next synced backward reduces the sum.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..parallel.mesh import get_hybrid_mesh
from . import communication as C

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        if group is None:
            hm = get_hybrid_mesh()
            group = hm.group("dp") if hm is not None else C.get_group(0)
        self._group = group
        self._sync = True
        for p in layers.parameters():
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._reduce)

    def _reduce(self, p) -> None:
        if self._sync and self._group is not None and \
                self._group.nranks > 1:
            C.all_reduce(p.grad, C.ReduceOp.AVG, self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backward inside the context leaves gradients local."""
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def scale_loss(self, loss):
        """Kept for source compatibility: the mean is taken by the
        gradient reduction, so the loss is returned as it is."""
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Reduce every gradient now (after backwards run under
        ``no_sync``)."""
        if self._group is None or self._group.nranks == 1:
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                C.all_reduce(p.grad, C.ReduceOp.AVG, self._group)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)
