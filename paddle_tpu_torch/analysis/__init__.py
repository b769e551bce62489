"""Load-time model transforms of the PyTorch port (the counterparts of
``paddle_tpu/analysis``'s rewrite passes), the serving engine's
paged-KV invariant checker and the static concurrency analysis of the
serving tree (``concurrency``: guarded-by lint, lock-order cycles, the
seeded fleet fuzzer)."""
from . import concurrency
from .concurrency import (analyze_source, analyze_tree, check_tree,
                          fuzz_fleet_scenario, mutate_remove_with)
from .kv_invariants import (KVInvariantError, Violation, audit_defrag_plan,
                            audit_engine, audit_serving_state)
from .rewrite_conv import ConvBnAct, FoldResult, fold_conv_bn

__all__ = ["ConvBnAct", "FoldResult", "fold_conv_bn", "KVInvariantError",
           "Violation", "audit_serving_state", "audit_defrag_plan",
           "audit_engine", "concurrency", "analyze_source", "analyze_tree",
           "check_tree", "fuzz_fleet_scenario", "mutate_remove_with"]
