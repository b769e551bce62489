"""paddle_tpu_torch.distributed — ``paddle.distributed`` over
``torch.distributed``, one process a rank.

Port of the parts of ``paddle_tpu/distributed`` the parallel train step
stands on: the environment (``env``), the collective API
(``communication``, with a per-kind counter), axis-named collectives
over the hybrid mesh (``functional``), sequence parallelism, ZeRO
(``sharding``), the tensor-parallel layers (``mpu``), ``DataParallel``,
``fleet`` and the launcher ``spawn``. Checkpoints, the auto-parallel API,
the ``launch`` CLI, the store and the watchdog come in later slices.
"""
from . import (communication, fleet, functional, mpu,
               sequence_parallel, sharding)
from .communication import (Group, ReduceOp, all_gather, all_gather_object,
                            all_reduce, alltoall, alltoall_single, barrier,
                            broadcast, broadcast_object_list,
                            collective_stats, destroy_process_group, gather,
                            get_backend, get_group, irecv, is_available,
                            isend, new_group, recv, reduce, reduce_scatter,
                            reset_collective_stats, scatter,
                            scatter_object_list, send,
                            set_collective_timing, wait)
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .mpu import split
from .parallel import DataParallel
from .sharding import group_sharded_parallel
from .spawn import SpawnError, spawn

__all__ = [
    "communication", "fleet", "functional", "mpu", "sequence_parallel",
    "sharding", "Group", "ReduceOp", "all_gather", "all_gather_object",
    "all_reduce", "alltoall", "alltoall_single", "barrier", "broadcast",
    "broadcast_object_list", "collective_stats", "destroy_process_group",
    "gather", "get_backend", "get_group", "irecv", "is_available", "isend",
    "new_group", "recv", "reduce", "reduce_scatter",
    "reset_collective_stats", "scatter", "scatter_object_list", "send",
    "set_collective_timing", "wait", "ParallelEnv", "get_rank",
    "get_world_size", "init_parallel_env", "is_initialized", "split",
    "DataParallel", "group_sharded_parallel", "spawn", "SpawnError"]
