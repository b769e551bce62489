"""ZeRO / group-sharded parallelism (sharding stages 1-3).

Port of ``paddle_tpu/distributed/sharding.py`` (reference:
``fleet/meta_parallel/sharding/`` and
``dygraph_sharding_optimizer.py:48``). The JAX package makes ZeRO a
layout: it shards the first free dp-divisible dim of each array over
the mesh's dp axis (``zero_spec``) and lets GSPMD emit the collectives.
The port keeps ``zero_spec`` as it is and runs the schedule itself: each
dp rank owns the ``zero_spec`` slice of every array.

* ``zero_spec``: the JAX function, line for line.
* ``ShardedOptimizer`` (``shard_optimizer_states``,
  ``DygraphShardingOptimizer``, ``group_sharded_parallel``) over the
  port's Paddle optimizers (``optimizer/optimizer.py``): stage 1
  (``"os"``) all-reduces each gradient over dp (its mean), updates this
  rank's slice of the parameter with slice-sized optimizer state, and
  all-gathers the parameter; stage 2 (``"os_g"``) reduce-scatters the
  gradient into the slice instead; stage 3 (``"p_g_os"``,
  ``shard_parameters``) also keeps the parameter as its slice between
  steps and all-gathers it before the model's forward. A parameter with
  no dp-divisible dim stays whole (its gradient all-reduced), with a
  warning, as the JAX ``_dp_shard`` does.

The dp group is this rank's dp line of the global hybrid mesh.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..parallel.mesh import P, get_hybrid_mesh
from . import communication as C

__all__ = ["zero_spec", "zero_dim", "shard_optimizer_states",
           "shard_parameters", "group_sharded_parallel",
           "DygraphShardingOptimizer", "ShardedOptimizer"]


def zero_spec(base_spec, shape, dp: int, axis: str = "dp"):
    """ZeRO layout for one array: shard the first dp-divisible,
    not-already-sharded dim over the dp axis; None when no dim qualifies
    (caller decides whether that is a warning or an error).

    An array whose base spec already uses ``axis`` is already
    zero-sharded and returns None too — re-adding the axis on a second
    dim would build an invalid duplicate-axis PartitionSpec (the
    zero3-then-zero1 double-placement bug the sharding lint pinned:
    optimizer moments inherit the param's zero3 spec and must not be
    dp-sharded again)."""
    names = list(base_spec) + [None] * (len(shape) - len(base_spec))
    if any(n == axis or (isinstance(n, (tuple, list)) and axis in n)
           for n in names):
        return None
    for i, (n, s) in enumerate(zip(names, shape)):
        if n is None and s and s % dp == 0:
            names[i] = axis
            return P(*names)
    return None


def zero_dim(base_spec, shape, dp: int) -> Optional[int]:
    """The dim ``zero_spec`` puts on dp (None: the array stays whole)."""
    if dp <= 1:
        return None
    zs = zero_spec(base_spec, shape, dp)
    return None if zs is None else list(zs).index("dp")


def _dp_group():
    hm = get_hybrid_mesh()
    if hm is None or hm.dp_degree <= 1:
        return None
    return hm.group("dp")


def _owned(p: torch.Tensor, g) -> Optional[int]:
    """The dim of ``p`` this rank owns a slice of (None: whole, with a
    warning, as the JAX ``_dp_shard``)."""
    if hasattr(p, "zero_dim"):
        return p.zero_dim
    dim = zero_dim(P(), tuple(p.shape), g.nranks)
    if dim is None and p.dim():
        warnings.warn(f"ZeRO: array of shape {tuple(p.shape)} has no dim "
                      f"divisible by dp={g.nranks}; it stays whole on "
                      f"every rank")
    return dim


class ShardedOptimizer:
    """Stage ``1``–``3`` over a port Paddle optimizer (see the module
    docstring); every other attribute is the inner optimizer's."""

    def __init__(self, optimizer, stage: int = 1, group=None):
        if stage not in (1, 2, 3):
            raise ValueError(f"sharding stage must be 1, 2 or 3, got "
                             f"{stage}")
        if stage >= 2 and optimizer._grad_clip is not None:
            raise ValueError(
                "a gradient clip needs the whole gradient's norm; stages "
                "2 and 3 keep only this rank's slice of it")
        self._inner = optimizer
        self._stage = stage
        self._group = _dp_group() if group is None else group
        self._slices = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _slice(self, p):
        """``(dim, owned slice)`` of ``p``; the slice is a view of ``p``
        below stage 3, the parameter's own storage at stage 3."""
        key = id(p)
        if key not in self._slices:
            dim = _owned(p, self._group)
            if dim is None:
                self._slices[key] = (None, p)
            elif hasattr(p, "zero_slice"):
                self._slices[key] = (dim, p.zero_slice)
            else:
                self._slices[key] = (dim, C.rank_part(p.data, dim,
                                                    self._group))
        return self._slices[key]

    @torch.no_grad()
    def step(self):
        opt, g = self._inner, self._group
        if g is None:
            return opt.step()
        opt._sync_lr()
        pgs = [(p, p.grad) for p in opt._param_list
               if p.requires_grad and p.grad is not None]
        if self._stage == 1:    # the mean over dp, whole
            for _, grad in pgs:
                C.all_reduce(grad, C.ReduceOp.AVG, g)
        if opt._grad_clip is not None:
            clipped = opt._grad_clip(pgs)
            pgs = [(p, c) for (p, _), (_, c) in zip(pgs, clipped)]
        opt._step_count += 1
        for p, grad in pgs:
            dim, own = self._slice(p)
            if dim is None:
                if self._stage > 1:
                    C.all_reduce(grad, C.ReduceOp.AVG, g)
                gs = grad
            elif self._stage == 1:
                gs = C.rank_part(grad, dim, g)
            else:
                gs = C.reduce_scatter_dim(grad, dim, g, C.ReduceOp.AVG)
            opt._apply_one(own, gs, opt._lr, opt._master(own),
                           opt._decay_coeff(p))
            if dim is not None and self._stage < 3:
                parts = C.all_gather(None, own.contiguous(), g)
                n = own.shape[dim]
                for i, part in enumerate(parts):
                    p.data.narrow(dim, i * n, n).copy_(part)
        if self._stage == 3:
            _release(opt._param_list)

    def clear_grad(self, set_to_zero: bool = False):
        return self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


def _release(params) -> None:
    """Stage 3: drop each sharded parameter's whole storage."""
    for p in params:
        if hasattr(p, "zero_slice"):
            p.data = p.zero_slice.new_empty(0)


def _gather_hook(module, args):
    """Stage 3: all-gather each sharded parameter before the forward."""
    g = _dp_group()
    for p in module.parameters():
        if hasattr(p, "zero_slice") and p.numel() == 0:
            p.data = C.all_gather_cat(p.zero_slice, p.zero_dim, g)


def shard_optimizer_states(optimizer):
    """Stage 1: optimizer state sharded over dp
    (``DygraphShardingOptimizer``)."""
    return ShardedOptimizer(optimizer, stage=1)


def shard_parameters(model):
    """Stage 3's parameter half: each parameter with a dp-divisible dim
    keeps this rank's slice (``p.zero_slice``, ``p.zero_dim``) and drops
    its whole storage; a forward pre-hook all-gathers them before each
    forward (``GroupShardedStage3``'s rebuild-on-forward)."""
    g = _dp_group()
    if g is None:
        return model
    for p in model.parameters():
        dim = _owned(p, g)
        if dim is None:
            continue
        p.zero_dim = dim
        p.zero_slice = C.rank_part(p.data, dim, g).clone()
    _release(model.parameters())
    model.register_forward_pre_hook(_gather_hook)
    return model


_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False,
                           dp_group=None, exclude_layer=None):
    """Reference: ``paddle.distributed.sharding.group_sharded_parallel``.
    level: ``"os"`` (stage 1) | ``"os_g"`` (stage 2) | ``"p_g_os"``
    (stage 3). Returns ``(model, optimizer, scaler)``.

    The knobs of the reference's own communication schedule
    (``offload``, ``sync_buffers``, ``buffer_max_size``,
    ``segment_size``, ``sync_comm``) change nothing here and warn, as in
    the JAX package: the port reduces each gradient once, in order."""
    if level not in _LEVELS:
        raise ValueError(
            f"unknown sharding level {level!r}: expected 'os' (stage 1, "
            "optimizer state), 'os_g' (stage 2, + gradients) or "
            "'p_g_os' (stage 3, + parameters)")
    for name, val in [("offload", offload), ("sync_buffers", sync_buffers),
                      ("buffer_max_size", buffer_max_size),
                      ("segment_size", segment_size),
                      ("sync_comm", sync_comm)]:
        if val:
            warnings.warn(f"group_sharded_parallel({name}=...) has no "
                          f"effect in the port", stacklevel=2)
    stage = _LEVELS[level]
    if stage == 3:
        model = shard_parameters(model)
    return model, ShardedOptimizer(optimizer, stage, dp_group or group), \
        scaler


class DygraphShardingOptimizer(ShardedOptimizer):
    """Stage 1 over ``optimizer`` (dygraph_sharding_optimizer.py:48)."""

    def __init__(self, optimizer, hcg=None):
        super().__init__(optimizer, stage=1)
