"""paddle_tpu_torch.distributed — ``paddle.distributed`` over
``torch.distributed``, one process a rank.

Port of ``paddle_tpu/distributed`` but its auto-parallel API: the
environment (``env``), the collective API (``communication``, with a
per-kind counter, and the gloo bootstrap helpers), axis-named
collectives over the hybrid mesh (``functional``), sequence
parallelism, ZeRO (``sharding``), the tensor-parallel layers (``mpu``),
``DataParallel``, ``fleet``; the fault-tolerance path of training:
sharded train-state checkpoints with elastic resume (``checkpoint``,
``io``, ``save_state_dict`` / ``load_state_dict``), the ``launch`` CLI
(``python -m paddle_tpu_torch.distributed.launch``) with its restarts,
the ``TCPStore`` (``store``) and the step ``Watchdog``; the
parallel-config ``auto_tuner``; and ``spawn``, which starts a world from
Python. The auto-parallel API (``ProcessMesh``, placements,
``shard_tensor``, the engine) comes in a later slice.
"""
from . import (auto_tuner, checkpoint, communication, fleet, functional,
               io, mpu, sequence_parallel, sharding, store)
from .communication import (Group, ReduceOp, all_gather, all_gather_object,
                            all_reduce, alltoall, alltoall_single, barrier,
                            broadcast, broadcast_object_list,
                            collective_stats, destroy_process_group, gather,
                            get_backend, get_group, gloo_barrier,
                            gloo_init_parallel_env, gloo_release, irecv,
                            is_available, isend, new_group, recv, reduce,
                            reduce_scatter, reset_collective_stats, scatter,
                            scatter_object_list, send,
                            set_collective_timing, wait)
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .extras import load_state_dict, save_state_dict
from .mpu import split
from .parallel import DataParallel
from .sharding import group_sharded_parallel
from .spawn import SpawnError, spawn
from .store import TCPStore
from .watchdog import Watchdog
from . import launch  # noqa: E402  (the CLI's package)

__all__ = [
    "auto_tuner", "checkpoint", "communication", "fleet", "functional",
    "io", "launch", "mpu", "sequence_parallel", "sharding", "store",
    "Group", "ReduceOp", "all_gather", "all_gather_object",
    "all_reduce", "alltoall", "alltoall_single", "barrier", "broadcast",
    "broadcast_object_list", "collective_stats", "destroy_process_group",
    "gather", "get_backend", "get_group", "gloo_barrier",
    "gloo_init_parallel_env", "gloo_release", "irecv", "is_available",
    "isend", "new_group", "recv", "reduce", "reduce_scatter",
    "reset_collective_stats", "scatter", "scatter_object_list", "send",
    "set_collective_timing", "wait", "ParallelEnv", "get_rank",
    "get_world_size", "init_parallel_env", "is_initialized", "split",
    "DataParallel", "group_sharded_parallel", "spawn", "SpawnError",
    "TCPStore", "Watchdog", "save_state_dict", "load_state_dict"]
