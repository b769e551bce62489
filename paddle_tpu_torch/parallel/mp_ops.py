"""Megatron's tensor-parallel autograd pairs over a mesh axis's group.

Port of ``paddle_tpu/parallel/mp_ops.py``: the reference's
``c_identity`` / ``_mp_allreduce`` (the "f" / "g" operators), as
``torch.autograd.Function``s over the process group of this rank's line
of an axis of the global hybrid mesh:

* ``psum_fwd_identity_bwd`` ("g"): all-reduce in forward (a
  row-parallel product's partial sums), identity in backward;
* ``identity_fwd_psum_bwd`` ("f"): identity in forward (a replicated
  stream entering column-parallel weights), all-reduce of the cotangent
  in backward, so every replicated weight upstream gets its whole
  gradient on each rank.

Both are the identity at axis size 1. Beside them, the reference's
``c_split`` / ``c_concat`` pair: ``split_fwd_gather_bwd`` (this rank's
part of a replicated tensor; backward all-gathers) and
``gather_fwd_split_bwd`` (the reverse).

``axis`` is a mesh axis name (``"tp"``) or a ``Group``.
"""
from __future__ import annotations

import torch


def _comm():
    # imported at call time: the distributed package imports this module
    from ..distributed import communication
    return communication

__all__ = ["identity_fwd_psum_bwd", "psum_fwd_identity_bwd",
           "split_fwd_gather_bwd", "gather_fwd_split_bwd", "axis_group"]


def axis_group(axis):
    """The ``Group`` of ``axis`` through this rank (None: one rank)."""
    if axis is None or not isinstance(axis, str):
        return axis
    from .mesh import get_hybrid_mesh
    hm = get_hybrid_mesh()
    return None if hm is None else hm.group(axis)


def _live(g) -> bool:
    return g is not None and g.nranks > 1


class _PsumFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        out = x.clone()
        _comm().all_reduce(out, "sum", g)
        return out

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _PsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        _comm().all_reduce(ct, "sum", ctx.g)
        return ct, None


def _part(x, dim: int, g):
    return _comm().rank_part(x, dim, g).contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _part(x, dim, g)

    @staticmethod
    def backward(ctx, ct):
        return _comm().all_gather_cat(ct.contiguous(), ctx.dim,
                                      ctx.g), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _comm().all_gather_cat(x.contiguous(), dim, g)

    @staticmethod
    def backward(ctx, ct):
        return _part(ct, ctx.dim, ctx.g), None, None


def psum_fwd_identity_bwd(x: torch.Tensor, axis="tp") -> torch.Tensor:
    """All-reduce ``x`` over ``axis``; the backward is the identity."""
    g = axis_group(axis)
    return _PsumFwd.apply(x, g) if _live(g) else x


def identity_fwd_psum_bwd(x: torch.Tensor, axis="tp") -> torch.Tensor:
    """Identity forward; the backward all-reduces the cotangent."""
    g = axis_group(axis)
    return _PsumBwd.apply(x, g) if _live(g) else x


def split_fwd_gather_bwd(x: torch.Tensor, dim: int, axis="tp"):
    """This rank's equal part of ``x`` along ``dim``; the backward
    all-gathers the cotangent."""
    g = axis_group(axis)
    if not _live(g):
        return x
    if x.shape[dim] % g.nranks:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {g.nranks} ranks")
    return _Split.apply(x, dim, g)


def gather_fwd_split_bwd(x: torch.Tensor, dim: int, axis="tp"):
    """Every rank's ``x`` concatenated along ``dim``; the backward takes
    this rank's part of the cotangent."""
    g = axis_group(axis)
    return _Gather.apply(x, dim, g) if _live(g) else x
