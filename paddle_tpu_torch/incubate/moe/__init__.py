"""Port of ``paddle_tpu.incubate.moe``: the functional MoE FFN, dropless
(grouped-matmul kernels) and capacity-dispatch (einsum)."""
from .functional import (default_capacity, moe_expert_compute, moe_ffn,
                         moe_ffn_dropless, top_k_gating)

__all__ = ["default_capacity", "top_k_gating", "moe_ffn_dropless",
           "moe_expert_compute", "moe_ffn"]
