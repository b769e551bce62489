"""Load-time model transforms of the PyTorch port (the counterparts of
``paddle_tpu/analysis``'s rewrite passes) and the serving engine's
paged-KV invariant checker."""
from .kv_invariants import (KVInvariantError, Violation, audit_defrag_plan,
                            audit_engine, audit_serving_state)
from .rewrite_conv import ConvBnAct, FoldResult, fold_conv_bn

__all__ = ["ConvBnAct", "FoldResult", "fold_conv_bn", "KVInvariantError",
           "Violation", "audit_serving_state", "audit_defrag_plan",
           "audit_engine"]
