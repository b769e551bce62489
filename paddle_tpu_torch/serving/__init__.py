"""Continuous-batching serving over the paged KV cache (PyTorch port of
``paddle_tpu/serving``)."""
from .engine import ServingEngine
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .scheduler import (CANCELLED, COMPLETED, QUEUED, REJECTED, RUNNING,
                        TIMED_OUT, Request, RequestHandle, Scheduler)

__all__ = ["ServingEngine", "ServingMetrics", "PrefixCache", "Request",
           "RequestHandle", "Scheduler", "QUEUED", "RUNNING", "COMPLETED",
           "CANCELLED", "TIMED_OUT", "REJECTED"]
