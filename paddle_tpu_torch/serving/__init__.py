"""Continuous-batching serving over the paged KV cache (PyTorch port of
``paddle_tpu/serving``): ``ServingEngine`` serves Llama and Qwen2-MoE
(the model from ``model=`` or the config's type); ``ServingFleet`` runs
N engine replicas behind ``FleetRouter`` (serving/fleet/); ``locktrace``
traces the serving locks. The engine's span tracer, flight recorder and
recompile sentinel live in ``paddle_tpu_torch/observability``."""
from .engine import ServingEngine
from .fleet import (DRAINING, GONE, JOINING, ROLE_DECODE, ROLE_GENERAL,
                    ROLE_PREFILL, SERVING, FleetRouter, Replica,
                    ServingFleet)
from .metrics import Histogram, ServingMetrics, merge_exposition
from .prefix_cache import ColdTier, PrefixCache, prefix_fingerprints
from .scheduler import (CANCELLED, COMPLETED, QUEUED, REJECTED, RUNNING,
                        TIMED_OUT, Request, RequestHandle, Scheduler)
from .speculative import AcceptancePolicy, NGramDrafter

__all__ = ["ServingEngine", "ServingMetrics", "Histogram",
           "merge_exposition", "PrefixCache", "ColdTier",
           "prefix_fingerprints", "Request",
           "RequestHandle", "Scheduler", "QUEUED", "RUNNING", "COMPLETED",
           "CANCELLED", "TIMED_OUT", "REJECTED", "AcceptancePolicy",
           "NGramDrafter", "ServingFleet", "FleetRouter", "Replica",
           "JOINING", "SERVING", "DRAINING", "GONE", "ROLE_GENERAL",
           "ROLE_PREFILL", "ROLE_DECODE"]
