"""paddle_tpu_torch.parallel — the hybrid mesh and Megatron's autograd
pairs over ``torch.distributed``.

Port of ``paddle_tpu/parallel`` (``mesh.py``, ``mp_ops.py``). One
process a rank; the mesh lays the ranks on the JAX package's axis grid
and holds one process group for each line of each axis. The pipeline
executors and context parallelism come in a later slice.
"""
from .mesh import (P, HybridMesh, get_hybrid_mesh, init_hybrid_mesh,
                   mesh_axis_size)
from .mp_ops import (gather_fwd_split_bwd, identity_fwd_psum_bwd,
                     psum_fwd_identity_bwd, split_fwd_gather_bwd)

__all__ = ["P", "HybridMesh", "init_hybrid_mesh", "get_hybrid_mesh",
           "mesh_axis_size", "identity_fwd_psum_bwd",
           "psum_fwd_identity_bwd", "split_fwd_gather_bwd",
           "gather_fwd_split_bwd"]
