"""Process and rank environment over ``torch.distributed``.

Port of ``paddle_tpu/distributed/env.py``. The JAX package is one
process over many devices; the port is one process a rank, as Paddle's
own collective mode is, so ``init_parallel_env`` joins a
``torch.distributed`` process group.

Rank and world size come from the environment, so the same call works
under ``distributed.spawn`` and under a launcher: ``RANK`` /
``WORLD_SIZE`` (torch's names) or ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` (Paddle's). The rendezvous is
``PADDLE_INIT_METHOD`` when set (``spawn`` sets a ``file://`` store, so
test files running side by side never race for a port), else
``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).

The backend is picked once, from the layout: ``"nccl"`` when every rank
has a card of its own (``world_size <= torch.cuda.device_count()`` and
the ranks run on the card), ``"gloo"`` otherwise — ranks that share one
card (NCCL refuses two ranks of a communicator on one device) and the
CPU. The choice is logged; ``backend=`` names it explicitly.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "ParallelEnv", "pick_backend", "rank_device"]

_log = logging.getLogger(__name__)


def _env_int(*names: str, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def pick_backend(world_size: int, device: torch.device) -> str:
    """``"nccl"`` when each of ``world_size`` ranks on ``device``'s type
    has a card of its own, ``"gloo"`` otherwise."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` if given (``"cpu"``
    for the CPU), else the card — ``cuda:LOCAL_RANK`` when the host has
    a card a rank, ``cuda:0`` when the ranks share one."""
    if device is not None:
        return resolve_device(device)
    dev = resolve_device(None)
    local = _env_int("LOCAL_RANK", default=0)
    if local < torch.cuda.device_count():
        dev = torch.device("cuda", local)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_parallel_env(backend: Optional[str] = None, device=None):
    """Join the process group of this rank (a no-op when joined).

    ``device``: where this rank computes (see ``rank_device``); it sets
    the backend unless ``backend`` is given. Returns the
    ``ParallelEnv``."""
    if is_initialized():
        return ParallelEnv()
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0)
    world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    dev = rank_device(device)
    if backend is None:
        backend = pick_backend(world, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = os.environ.get("PADDLE_INIT_METHOD", "env://")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _log.info("rank %d of %d joined over %s on %s", rank, world, backend,
              dev)
    return ParallelEnv()


def get_rank(group=None) -> int:
    if not is_initialized():
        return 0
    return dist.get_rank(getattr(group, "pg", group))


def get_world_size(group=None) -> int:
    if group is not None and getattr(group, "nranks", None):
        return group.nranks
    if not is_initialized():
        return 1
    return dist.get_world_size()


class ParallelEnv:
    """Reference: ``paddle.distributed.ParallelEnv`` (the launch
    topology as the environment states it)."""

    @property
    def rank(self) -> int:
        return get_rank()

    @property
    def world_size(self) -> int:
        return get_world_size()

    @property
    def local_rank(self) -> int:
        return _env_int("LOCAL_RANK", default=0)

    @property
    def device_id(self) -> int:
        return min(self.local_rank, max(torch.cuda.device_count() - 1, 0))

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if is_initialized() else None

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
