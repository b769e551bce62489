"""Hybrid-parallel topology over ``torch.distributed`` process groups.

Port of ``paddle_tpu/parallel/mesh.py``. The JAX package expresses the
topology as one device mesh with named axes; the port, one process a
rank, lays the ranks out on the same grid and builds one process group
for each line of each axis — the reference's ``HybridCommunicateGroup``
(one communicator per parallelism axis).

Axis order is the JAX one, ``(dp, pp[, cp][, ep], tp)``: tp innermost,
dp outermost; ``cp`` and ``ep`` exist only when their degree is above 1.
Rank ``r`` of the mesh sits where device ``r`` sits in JAX's
``np.array(devices[:need]).reshape(shape)``.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["P", "HybridMesh", "init_hybrid_mesh", "get_hybrid_mesh",
           "mesh_axis_size"]


class P(tuple):
    """A partition spec: one entry a dim, each an axis name, a tuple of
    axis names, or None (unsharded); trailing dims past its length are
    unsharded, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


_GLOBAL: list = [None]


class HybridMesh:
    """The rank grid, its axis names and one ``Group`` for each line of
    each axis. ``coords`` is this rank's position (None outside the
    mesh); ``group(axis)`` the line of ``axis`` through it."""

    def __init__(self, shape: Dict[str, int], ranks: Sequence[int],
                 groups: Dict[str, Dict[Tuple[int, ...], object]],
                 me: int):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.grid = np.asarray(list(ranks)).reshape(tuple(shape.values()))
        self._groups = groups
        self.rank = me
        hit = np.argwhere(self.grid == me)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None

    def degree(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def dp_degree(self) -> int:
        return self.degree("dp")

    @property
    def pp_degree(self) -> int:
        return self.degree("pp")

    @property
    def tp_degree(self) -> int:
        return self.degree("tp")

    @property
    def ep_degree(self) -> int:
        return self.degree("ep")

    @property
    def cp_degree(self) -> int:
        return self.degree("cp")

    @property
    def world_size(self) -> int:
        return int(self.grid.size)

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The ``Group`` of ranks that differ from this one only along
        ``axis`` (None for an absent axis: a line of one rank)."""
        if axis not in self.shape:
            return None
        i = self.axis_names.index(axis)
        key = self.coords[:i] + self.coords[i + 1:]
        return self._groups[axis][key]

    def __enter__(self):
        self._prev = _GLOBAL[0]
        _GLOBAL[0] = self
        return self

    def __exit__(self, *exc):
        _GLOBAL[0] = self._prev
        return False

    def __repr__(self) -> str:
        return f"HybridMesh({self.shape}, rank {self.rank} at {self.coords})"


def _mesh_shape(dp, pp, tp, ep, cp) -> Dict[str, int]:
    shape = {"dp": dp, "pp": pp}
    if cp > 1:
        shape["cp"] = cp
    if ep > 1:
        shape["ep"] = ep
    shape["tp"] = tp
    return shape


def init_hybrid_mesh(dp: int = 1, pp: int = 1, tp: int = 1, ep: int = 1,
                     cp: int = 1, ranks: Optional[Sequence[int]] = None,
                     set_global: bool = True) -> HybridMesh:
    """Build the hybrid mesh over ``ranks`` (the first
    ``dp·pp·tp·ep·cp`` ranks of the world when None): fleet's
    ``fleet.init(strategy)``. Every rank of the world calls it, members
    or not, in the same order (it creates the axes' process groups);
    a rank outside ``ranks`` gets a mesh whose ``is_member`` is False."""
    from ..distributed.communication import new_group
    from ..distributed.env import get_rank, get_world_size
    shape = _mesh_shape(dp, pp, tp, ep, cp)
    need = int(np.prod(list(shape.values())))
    world = get_world_size()
    ranks = list(range(need)) if ranks is None else list(ranks)
    if len(ranks) != need or max(ranks) >= world:
        raise ValueError(
            f"mesh dp*pp*tp*ep*cp={need} over ranks {ranks} does not fit "
            f"the world of {world} ranks")
    grid = np.asarray(ranks).reshape(tuple(shape.values()))
    names = list(shape)
    groups: Dict[str, Dict[Tuple[int, ...], object]] = {}
    for i, axis in enumerate(names):
        groups[axis] = {}
        others = [range(n) for j, n in enumerate(shape.values()) if j != i]
        for key in itertools.product(*others):
            idx = list(key[:i]) + [slice(None)] + list(key[i:])
            line = [int(r) for r in grid[tuple(idx)]]
            groups[axis][tuple(key)] = new_group(line)
    hm = HybridMesh(shape, ranks, groups, get_rank())
    if set_global:
        _GLOBAL[0] = hm
    return hm


def get_hybrid_mesh() -> Optional[HybridMesh]:
    return _GLOBAL[0]


def mesh_axis_size(axis: str) -> int:
    hm = get_hybrid_mesh()
    return hm.degree(axis) if hm is not None else 1
