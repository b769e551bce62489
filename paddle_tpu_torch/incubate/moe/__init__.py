"""Port of ``paddle_tpu.incubate.moe``: the functional MoE FFN, dropless
(grouped-matmul kernels) and capacity-dispatch (einsum, on one device or
expert-parallel over the hybrid mesh), and ``MoELayer`` with its gates."""
from .functional import (default_capacity, moe_expert_compute, moe_ffn,
                         moe_ffn_dropless, moe_ffn_sharded, record_dropped,
                         top_k_gating)
from .gate import GShardGate, NaiveGate, SwitchGate
from .layer import ExpertLayer, MoELayer

__all__ = ["default_capacity", "top_k_gating", "moe_ffn_dropless",
           "moe_expert_compute", "moe_ffn", "moe_ffn_sharded",
           "record_dropped", "NaiveGate", "GShardGate", "SwitchGate",
           "MoELayer", "ExpertLayer"]
