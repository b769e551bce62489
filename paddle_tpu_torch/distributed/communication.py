"""The Paddle collective API over ``torch.distributed``.

Port of ``paddle_tpu/distributed/communication.py``. The JAX package is
single-controller: its process-level collectives are identities in one
process and the device-level ones live inside ``jit``. The port is one
process a rank, so every call here is a real collective over a
``torch.distributed`` process group, in place on its tensors as in
Paddle (``sync_op=False`` returns a task with ``wait()``).

Every op is the backend's own call, with two exceptions, each one code
path for every backend or for gloo alone (``tools/
torch_gloo_cuda_probe.py`` lists what gloo takes on CUDA tensors):

* gloo aborts the process on a point-to-point message in device memory,
  so over gloo ``send``, ``recv``, ``isend``, ``irecv`` and
  ``exchange`` move CUDA tensors through host copies;
* gloo has no list all-to-all, so ``alltoall`` stacks the list and runs
  ``all_to_all_single`` on every backend (equal shapes, as Paddle's).

``ReduceOp.AVG`` is a sum divided by the group's size on every backend
(gloo has no average).

Every call adds to a per-process counter by kind (``collective_stats()``,
zeroed by ``reset_collective_stats()``, as the kernels' ``launches``):
``calls``, ``bytes`` — the size of the op's whole buffer: the tensor of
an all-reduce, broadcast or reduce, the gathered output of an
all-gather, the full input of a reduce-scatter, what a rank sends and
receives in an all-to-all, a p2p message — and ``seconds`` of host wall
time. ``set_collective_timing(True)`` synchronizes the card before and
after each collective, so ``seconds`` holds the collectives alone and
not the kernels queued ahead of them.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from .env import get_rank, get_world_size, is_initialized

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "broadcast", "reduce",
           "scatter", "gather", "alltoall", "alltoall_single",
           "reduce_scatter", "send", "recv", "isend", "irecv", "barrier",
           "get_backend", "wait", "destroy_process_group", "is_available",
           "broadcast_object_list", "scatter_object_list",
           "collective_stats", "reset_collective_stats",
           "set_collective_timing", "all_gather_cat", "reduce_scatter_dim",
           "rank_part", "exchange"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
             ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


class Group:
    """A communicator: global ``ranks`` and the torch process group over
    them (``pg`` None is the default world group). ``rank`` is this
    process's index in ``ranks``, -1 outside it."""

    def __init__(self, ranks: List[int], pg=None, gid: int = 0):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.pg = pg
        self.id = gid

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        me = get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    @property
    def backend(self) -> str:
        return dist.get_backend(self.pg)

    def __repr__(self) -> str:
        return f"Group(id={self.id}, ranks={self.ranks})"


_GROUPS: Dict[int, Group] = {}
_STATS: Dict[str, Dict[str, float]] = {}
_TIMING = [False]


def collective_stats() -> Dict[str, Dict[str, float]]:
    """``{kind: {"calls", "bytes", "seconds"}}`` since the last reset."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def set_collective_timing(on: bool) -> None:
    """Synchronize the card around each collective (see the module
    docstring), so ``seconds`` holds the collectives alone."""
    _TIMING[0] = bool(on)


class _Count:
    """Adds one call of ``kind`` moving ``nbytes`` to the counters, with
    its host wall time."""

    def __init__(self, kind: str, nbytes: int, cuda: bool):
        self.kind, self.nbytes, self.sync = kind, int(nbytes), (
            cuda and _TIMING[0])

    def __enter__(self):
        if self.sync:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        s = _STATS.setdefault(self.kind, {"calls": 0, "bytes": 0,
                                          "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += self.nbytes
        s["seconds"] += time.perf_counter() - self.t0
        return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _world() -> Group:
    if 0 not in _GROUPS:
        _GROUPS[0] = Group(list(range(get_world_size())), None, 0)
    return _GROUPS[0]


def _group(group: Optional[Group]) -> Group:
    return _world() if group is None else group


def _gloo(g: Group) -> bool:
    return dist.get_backend(g.pg) == "gloo"


def _op(op: str):
    return getattr(dist.ReduceOp, _TORCH_OP[op])


class _Done:
    """The task of a call that finished before it returned."""

    def __init__(self, result=None):
        self.result = result

    def wait(self, timeout=None):
        return True

    def is_completed(self) -> bool:
        return True


def _ret(result, sync_op: bool):
    return result if sync_op else _Done(result)


def new_group(ranks: Optional[List[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over the global ``ranks`` (all of them when None). As in
    ``torch.distributed.new_group``, every rank of the world calls it,
    members or not, in the same order."""
    ranks = list(range(get_world_size())) if ranks is None else list(ranks)
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    gid = max(_GROUPS, default=0) + 1
    _GROUPS[gid] = Group(ranks, pg, gid)
    return _GROUPS[gid]


def get_group(gid: int = 0) -> Group:
    """The group registered under ``gid`` (0: the world)."""
    return _world() if gid == 0 else _GROUPS[gid]


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM,
               group: Optional[Group] = None, sync_op: bool = True):
    """Reduce ``tensor`` in place over ``group``."""
    g = _group(group)
    with _Count("all_reduce", _nbytes(tensor), tensor.is_cuda):
        dist.all_reduce(tensor, _op(op), group=g.pg)
        if op == ReduceOp.AVG:
            tensor.div_(g.nranks)
    return _ret(tensor, sync_op)


def _gather_list(tensor: torch.Tensor, g: Group) -> List[torch.Tensor]:
    out = [torch.empty_like(tensor) for _ in range(g.nranks)]
    dist.all_gather(out, tensor.contiguous(), group=g.pg)
    return out


def all_gather(tensor_list: Optional[list], tensor: torch.Tensor,
               group: Optional[Group] = None, sync_op: bool = True):
    """Every rank's ``tensor``, in group order, into ``tensor_list``."""
    g = _group(group)
    with _Count("all_gather", _nbytes(tensor) * g.nranks, tensor.is_cuda):
        out = _gather_list(tensor, g)
    if tensor_list is None:
        return _ret(out, sync_op)
    tensor_list[:] = out
    return _ret(tensor_list, sync_op)


def all_gather_object(object_list: list, obj: Any,
                      group: Optional[Group] = None):
    g = _group(group)
    out = [None] * g.nranks
    with _Count("all_gather_object", len(pickle.dumps(obj)) * g.nranks,
                False):
        dist.all_gather_object(out, obj, group=g.pg)
    object_list[:] = out
    return object_list


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None, sync_op: bool = True):
    """``src``'s ``tensor`` (``src`` a global rank) into every rank's."""
    g = _group(group)
    with _Count("broadcast", _nbytes(tensor), tensor.is_cuda):
        dist.broadcast(tensor, src, group=g.pg)
    return _ret(tensor, sync_op)


def _host(t: torch.Tensor, g: Group) -> bool:
    """Whether a point-to-point message of ``t`` goes through a host copy
    (gloo aborts on one in device memory)."""
    return t.is_cuda and _gloo(g)


def reduce(tensor: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """The reduction over ``group`` into ``dst``'s ``tensor``."""
    g = _group(group)
    with _Count("reduce", _nbytes(tensor), tensor.is_cuda):
        dist.reduce(tensor, dst, _op(op), group=g.pg)
        if op == ReduceOp.AVG and get_rank() == dst:
            tensor.div_(g.nranks)
    return _ret(tensor, sync_op)


def scatter(tensor: torch.Tensor, tensor_list: Optional[list] = None,
            src: int = 0, group: Optional[Group] = None,
            sync_op: bool = True):
    """Rank ``i`` of ``group`` receives ``src``'s ``tensor_list[i]``."""
    g = _group(group)
    parts = None
    if get_rank() == src:
        parts = [t.contiguous() for t in tensor_list]
    with _Count("scatter", _nbytes(tensor), tensor.is_cuda):
        dist.scatter(tensor, parts, src, group=g.pg)
    return _ret(tensor, sync_op)


def gather(tensor: torch.Tensor, gather_list: Optional[list] = None,
           dst: int = 0, group: Optional[Group] = None,
           sync_op: bool = True):
    """Every rank's ``tensor`` into ``dst``'s ``gather_list``."""
    g = _group(group)
    out = [torch.empty_like(tensor) for _ in range(g.nranks)] \
        if get_rank() == dst else None
    with _Count("gather", _nbytes(tensor) * g.nranks, tensor.is_cuda):
        dist.gather(tensor.contiguous(), out, dst, group=g.pg)
    if out is None:
        return _ret(gather_list, sync_op)
    if gather_list is None:
        return _ret(out, sync_op)
    gather_list[:] = out
    return _ret(gather_list, sync_op)


def alltoall(in_tensor_list: list, out_tensor_list: Optional[list] = None,
             group: Optional[Group] = None, sync_op: bool = True):
    """Rank ``j`` receives every rank's ``in_tensor_list[j]`` (one shape
    for every tensor of every rank): ``all_to_all_single`` of the stacked
    list."""
    g = _group(group)
    ins = torch.stack(list(in_tensor_list))
    outs = torch.empty_like(ins)
    with _Count("alltoall", 2 * _nbytes(ins), ins.is_cuda):
        dist.all_to_all_single(outs, ins, group=g.pg)
    outs = list(outs.unbind(0))
    if out_tensor_list is None:
        return _ret(outs, sync_op)
    out_tensor_list[:] = outs
    return _ret(out_tensor_list, sync_op)


def alltoall_single(in_tensor: torch.Tensor, out_tensor: torch.Tensor,
                    in_split_sizes=None, out_split_sizes=None,
                    group: Optional[Group] = None, sync_op: bool = True):
    """Split dim 0 of ``in_tensor`` across the group's ranks and
    exchange; ``out_tensor`` receives every rank's part for this one."""
    g = _group(group)
    with _Count("alltoall_single", _nbytes(in_tensor) + _nbytes(out_tensor),
                in_tensor.is_cuda):
        dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                               out_split_sizes, in_split_sizes, group=g.pg)
    return _ret(out_tensor, sync_op)


def reduce_scatter(tensor: torch.Tensor, tensor_list: list,
                   op: str = ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True):
    """Rank ``i`` of ``group`` receives the reduction of every rank's
    ``tensor_list[i]`` into ``tensor``."""
    g = _group(group)
    full = torch.stack([t.contiguous() for t in tensor_list])
    tensor.copy_(_reduce_scatter_rows(full, op, g)[0])
    return _ret(tensor, sync_op)


def _reduce_scatter_rows(full: torch.Tensor, op: str,
                         g: Group) -> torch.Tensor:
    """Rows ``[r·n/p, (r+1)·n/p)`` of the reduction of ``full`` over the
    group (dim 0 divisible by its size)."""
    n = full.shape[0] // g.nranks
    full = full.contiguous()
    out = full.new_empty((n,) + tuple(full.shape[1:]))
    with _Count("reduce_scatter", _nbytes(full), full.is_cuda):
        dist.reduce_scatter(out, list(full.split(n)), _op(op), group=g.pg)
        if op == ReduceOp.AVG:
            out.div_(g.nranks)
    return out


def reduce_scatter_dim(x: torch.Tensor, dim: int, group: Optional[Group],
                       op: str = ReduceOp.SUM) -> torch.Tensor:
    """This rank's part of the reduction of ``x`` over ``group``, ``x``
    split evenly along ``dim`` (a new contiguous tensor)."""
    g = _group(group)
    if x.shape[dim] % g.nranks:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {g.nranks} ranks")
    full = x.movedim(dim, 0).contiguous()
    return _reduce_scatter_rows(full, op, g).movedim(0, dim).contiguous()


def rank_part(x: torch.Tensor, dim: int, group: Group) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` (a view): the part
    ``reduce_scatter_dim`` returns and ``all_gather_cat`` puts back."""
    n = x.shape[dim] // group.nranks
    return x.narrow(dim, group.rank * n, n)


def all_gather_cat(x: torch.Tensor, dim: int,
                   group: Optional[Group]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    g = _group(group)
    with _Count("all_gather", _nbytes(x) * g.nranks, x.is_cuda):
        parts = _gather_list(x, g)
    return torch.cat(parts, dim)


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    g = _group(group)
    with _Count("send", _nbytes(tensor), tensor.is_cuda):
        dist.send(tensor.cpu() if _host(tensor, g) else tensor.contiguous(),
                  dst, group=g.pg)
    return _ret(None, sync_op)


def recv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    g = _group(group)
    with _Count("recv", _nbytes(tensor), tensor.is_cuda):
        buf = torch.empty_like(tensor, device="cpu") if _host(tensor, g) \
            else tensor
        dist.recv(buf, src, group=g.pg)
        if buf is not tensor:
            tensor.copy_(buf)
    return _ret(tensor, sync_op)


def exchange(sends: list, recvs: list, group: Optional[Group] = None):
    """Post every ``(tensor, dst[, tag])`` of ``sends`` and ``(tensor,
    src[, tag])`` of ``recvs`` (global ranks) at once and wait for all,
    so a ring of sends cannot deadlock; received tensors are written in
    place. A message matches the receive of its pair of ranks and tag
    (0 when not given)."""
    g = _group(group)
    ops, back = [], []
    for t, peer, *tag in sends:
        with _Count("send", _nbytes(t), t.is_cuda):
            buf = t.cpu() if _host(t, g) else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, peer, group=g.pg,
                              tag=tag[0] if tag else 0))
    for t, peer, *tag in recvs:
        buf = torch.empty_like(t, device="cpu") if _host(t, g) else t
        back.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=g.pg,
                              tag=tag[0] if tag else 0))
    with _Count("recv", sum(_nbytes(r[0]) for r in recvs),
                any(r[0].is_cuda for r in recvs)):
        for w in dist.batch_isend_irecv(ops) if ops else []:
            w.wait()
        for t, buf in back:
            if buf is not t:
                t.copy_(buf)


def isend(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None):
    """``send`` as a task (the message is out when it returns)."""
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None):
    """``recv`` as a task (the message is in when it returns)."""
    return recv(tensor, src, group, sync_op=False)


def barrier(group: Optional[Group] = None):
    g = _group(group)
    with _Count("barrier", 0, False):
        dist.barrier(group=g.pg)


def is_available() -> bool:
    return dist.is_available()


def get_backend(group: Optional[Group] = None) -> str:
    return dist.get_backend(_group(group).pg)


def wait(tensor: torch.Tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True):
    """A collective's result is ready when the call returns; on the card
    this also waits for the current stream."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def destroy_process_group(group: Optional[Group] = None):
    """Leave ``group`` (the whole process group when None)."""
    if group is None or group.id == 0:
        if is_initialized():
            dist.destroy_process_group()
        _GROUPS.clear()
        return
    dist.destroy_process_group(group.pg)
    _GROUPS.pop(group.id, None)


def broadcast_object_list(object_list: list, src: int = 0,
                          group: Optional[Group] = None):
    g = _group(group)
    with _Count("broadcast_object", len(pickle.dumps(list(object_list))),
                False):
        dist.broadcast_object_list(object_list, src, group=g.pg)
    return object_list


def scatter_object_list(out_object_list: list, in_object_list=None,
                        src: int = 0, group: Optional[Group] = None):
    """Rank ``r`` of ``group`` receives the ``r``-th equal slice of
    ``src``'s list (its length a multiple of the group's size)."""
    g = _group(group)
    holder = [list(in_object_list or [])]
    broadcast_object_list(holder, src, g)
    objs = holder[0]
    if not objs:
        raise ValueError("scatter_object_list: src rank provided no objects")
    if len(objs) % g.nranks:
        raise ValueError(f"scatter_object_list: {len(objs)} objects not "
                         f"divisible by the group's {g.nranks} ranks")
    per = len(objs) // g.nranks
    out_object_list[:] = objs[g.rank * per:(g.rank + 1) * per]
    return out_object_list
