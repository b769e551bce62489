"""Continuous-batching serving over the paged KV cache (PyTorch port of
``paddle_tpu/serving``): ``ServingEngine`` serves Llama and Qwen2-MoE
(the model from ``model=`` or the config's type)."""
from .engine import ServingEngine
from .metrics import ServingMetrics
from .prefix_cache import ColdTier, PrefixCache, prefix_fingerprints
from .scheduler import (CANCELLED, COMPLETED, QUEUED, REJECTED, RUNNING,
                        TIMED_OUT, Request, RequestHandle, Scheduler)
from .speculative import AcceptancePolicy, NGramDrafter

__all__ = ["ServingEngine", "ServingMetrics", "PrefixCache", "ColdTier",
           "prefix_fingerprints", "Request",
           "RequestHandle", "Scheduler", "QUEUED", "RUNNING", "COMPLETED",
           "CANCELLED", "TIMED_OUT", "REJECTED", "AcceptancePolicy",
           "NGramDrafter"]
