"""paddle_tpu_torch.parallel — the hybrid mesh, Megatron's autograd pairs
and the pipeline executors over ``torch.distributed``.

Port of ``paddle_tpu/parallel`` (``mesh.py``, ``mp_ops.py``,
``pipeline_spmd.py``, ``pipeline_1f1b.py``, ``pipeline_async.py``). One
process a rank; the mesh lays the ranks on the JAX package's axis grid
and holds one process group for each line of each axis; the pipeline
executors walk each rank's part of a schedule and exchange activations
with its pp neighbours. Context parallelism comes in a later slice.
"""
from .mesh import (P, HybridMesh, get_hybrid_mesh, init_hybrid_mesh,
                   mesh_axis_size)
from .mp_ops import (gather_fwd_split_bwd, identity_fwd_psum_bwd,
                     psum_fwd_identity_bwd, split_fwd_gather_bwd)
from .pipeline_spmd import microbatch, pipeline_spmd, stack_stage_params
from .pipeline_1f1b import (pipeline_train_1f1b, schedule_efficiency,
                            schedule_ticks, split_chunks_round_robin)
from .pipeline_async import Schedule, build_schedule, pipeline_train_async

__all__ = ["P", "HybridMesh", "init_hybrid_mesh", "get_hybrid_mesh",
           "mesh_axis_size", "identity_fwd_psum_bwd",
           "psum_fwd_identity_bwd", "split_fwd_gather_bwd",
           "gather_fwd_split_bwd", "pipeline_spmd", "stack_stage_params",
           "microbatch", "pipeline_train_1f1b", "schedule_efficiency",
           "schedule_ticks", "split_chunks_round_robin", "Schedule",
           "build_schedule", "pipeline_train_async"]
