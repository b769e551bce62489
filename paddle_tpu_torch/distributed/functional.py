"""Axis-named collectives over the global hybrid mesh's groups.

Port of ``paddle_tpu/distributed/functional.py``: the JAX functions are
``lax`` collectives over a named mesh axis inside ``shard_map``; here
each names an axis of ``parallel.get_hybrid_mesh()`` and runs over this
rank's line of it (``HybridMesh.group``). They return new tensors and
do not differentiate (the autograd pairs are ``parallel.mp_ops`` and
``distributed.sequence_parallel``). An axis the mesh lacks has one
rank: every function is then the identity on its input.
"""
from __future__ import annotations

import torch

from . import communication as C

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "ppermute", "send_recv_next", "axis_index"]

_OPS = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
        "min": C.ReduceOp.MIN, "avg": C.ReduceOp.AVG,
        "mean": C.ReduceOp.AVG}


def _axis_group(axis_name: str):
    from ..parallel.mesh import get_hybrid_mesh
    hm = get_hybrid_mesh()
    if hm is None:
        raise RuntimeError("no hybrid mesh: call parallel.init_hybrid_mesh")
    return hm.group(axis_name)


def all_reduce(x: torch.Tensor, axis_name: str, op: str = "sum"):
    g = _axis_group(axis_name)
    out = x.clone()
    if g is not None and g.nranks > 1:
        C.all_reduce(out, _OPS[op], g)
    return out


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0,
               tiled: bool = True):
    """Every rank's ``x`` along the mesh axis: concatenated along
    ``axis`` (``tiled``) or stacked on a new ``axis``."""
    g = _axis_group(axis_name)
    n = 1 if g is None else g.nranks
    if not tiled:
        x = x.unsqueeze(axis)
    return x.clone() if n == 1 else C.all_gather_cat(x, axis, g)


def reduce_scatter(x: torch.Tensor, axis_name: str, axis: int = 0):
    """This rank's part, along ``axis``, of the sum over the mesh axis."""
    g = _axis_group(axis_name)
    if g is None or g.nranks == 1:
        return x.clone()
    return C.reduce_scatter_dim(x, axis, g)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = True):
    """Split ``x`` along ``split_axis`` into one part a rank of the mesh
    axis, exchange, and concatenate what arrives along ``concat_axis``
    (``tiled``; otherwise the parts stack on a new ``concat_axis``)."""
    g = _axis_group(axis_name)
    n = 1 if g is None else g.nranks
    parts = list(x.chunk(n, split_axis)) if n > 1 else [x]
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    got = C.alltoall(parts, None, g) if n > 1 else [x.clone()]
    return torch.cat(got, concat_axis) if tiled \
        else torch.stack(got, concat_axis)


def ppermute(x: torch.Tensor, axis_name: str, perm):
    """Send ``x`` from axis index ``i`` to ``j`` for each ``(i, j)`` of
    ``perm``; an index that receives nothing gets zeros (as
    ``lax.ppermute``)."""
    g = _axis_group(axis_name)
    if g is None or g.nranks == 1:
        return x.clone() if (0, 0) in [tuple(p) for p in perm] \
            else torch.zeros_like(x)
    me = g.rank
    out = torch.zeros_like(x)
    sends = [(x, g.ranks[j]) for i, j in perm if i == me and j != me]
    recvs = [(out, g.ranks[i]) for i, j in perm if j == me and i != me]
    if (me, me) in [tuple(p) for p in perm]:
        out.copy_(x)
    C.exchange(sends, recvs, g)
    return out


def send_recv_next(x: torch.Tensor, axis_name: str, n: int):
    """Ring shift to the next index along the axis (the p2p primitive
    of the pipeline schedules)."""
    return ppermute(x, axis_name, [(i, (i + 1) % n) for i in range(n)])


def axis_index(axis_name: str) -> int:
    from ..parallel.mesh import get_hybrid_mesh
    return get_hybrid_mesh().axis_index(axis_name)
