"""Megatron sequence parallelism.

Port of ``paddle_tpu/distributed/sequence_parallel.py`` (reference:
``fleet/utils/sequence_parallel_utils.py``, the ``AllGatherOp`` /
``ReduceScatterOp`` PyLayers :85-146 and the sequence-parallel linears
:255, :427). Between tensor-parallel regions the activations are
sequence-sharded over tp; entering a column-parallel product they are
all-gathered along the sequence, leaving a row-parallel one
reduce-scattered back.

* ``all_gather_sequence`` / ``reduce_scatter_sequence``: the pair as
  ``torch.autograd.Function``s over this rank's tp group, each one's
  backward the other;
* ``mark_sequence_parallel``: this rank's part of a replicated tensor
  along the sequence (the backward all-gathers);
* ``ColumnSequenceParallelLinear`` / ``RowSequenceParallelLinear``: the
  ``mpu`` linears with the gather before / the scatter after;
* ``register_sequence_parallel_allreduce_hooks``: parameters marked
  ``sequence_parallel`` (the norms inside the sharded stream) see only
  this rank's rows, so their gradients are all-reduced over tp after
  backward.
"""
from __future__ import annotations

import torch

from ..parallel.mp_ops import axis_group, split_fwd_gather_bwd
from . import communication as C
from .mpu import ColumnParallelLinear, RowParallelLinear

__all__ = ["all_gather_sequence", "reduce_scatter_sequence",
           "mark_sequence_parallel", "ColumnSequenceParallelLinear",
           "RowSequenceParallelLinear",
           "register_sequence_parallel_allreduce_hooks"]


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return C.all_gather_cat(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, ct):
        return C.reduce_scatter_dim(ct, ctx.dim, ctx.g), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return C.reduce_scatter_dim(x, dim, g)

    @staticmethod
    def backward(ctx, ct):
        return C.all_gather_cat(ct.contiguous(), ctx.dim, ctx.g), None, None


def all_gather_sequence(x: torch.Tensor, axis_name="tp",
                        seq_axis: int = 1) -> torch.Tensor:
    """Every tp rank's sequence part, concatenated along ``seq_axis``;
    the backward reduce-scatters the cotangent back."""
    g = axis_group(axis_name)
    if g is None or g.nranks == 1:
        return x
    return _GatherSeq.apply(x, seq_axis, g)


def reduce_scatter_sequence(x: torch.Tensor, axis_name="tp",
                            seq_axis: int = 1) -> torch.Tensor:
    """This rank's sequence part of the sum over tp; the backward
    all-gathers the cotangent."""
    g = axis_group(axis_name)
    if g is None or g.nranks == 1:
        return x
    return _ScatterSeq.apply(x, seq_axis, g)


def mark_sequence_parallel(t: torch.Tensor, seq_axis: int = 1):
    """This rank's part, along ``seq_axis``, of a tensor every tp rank
    holds whole: the sequence-sharded layout between blocks."""
    return split_fwd_gather_bwd(t, seq_axis, "tp")


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input is sequence-sharded
    ``[B, T/tp, in]``: all-gathered along the sequence first (its
    backward reduce-scatters, which also sums the ranks' partial input
    gradients)."""

    def forward(self, x):
        return self._local(all_gather_sequence(x, seq_axis=x.dim() - 2))


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output returns sequence-sharded: the
    partial products are reduce-scattered along the sequence, then the
    bias is added."""

    def forward(self, x):
        if not self.input_is_parallel:
            x = split_fwd_gather_bwd(x, x.dim() - 1, "tp")
        out = reduce_scatter_sequence(x @ self.weight,
                                      seq_axis=x.dim() - 2)
        return out if self.bias is None else out + self.bias


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """All-reduce over tp, after backward, the gradient of every
    parameter with ``sequence_parallel = True``; with
    ``accumulation_steps`` N, on every N-th accumulation (the summed
    gradient). Returns the hook handles."""
    g = axis_group("tp")
    handles = []
    if g is None or g.nranks == 1:
        return handles
    for p in model.parameters():
        if not getattr(p, "sequence_parallel", False):
            continue
        seen = [0]

        def hook(param, seen=seen):
            seen[0] += 1
            if seen[0] % accumulation_steps == 0:
                C.all_reduce(param.grad, C.ReduceOp.SUM, g)

        handles.append(p.register_post_accumulate_grad_hook(hook))
    return handles
