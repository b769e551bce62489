"""Multi-replica serving (port of ``paddle_tpu/serving/fleet``): N
``ServingEngine`` replicas behind a prefix-affinity router with
prefill/decode disaggregation and drain-on-failure, in one process.

    ServingFleet — N replicas + membership generations + aggregated
                   observability, the prefill->decode chain handoff
                   (fleet.py)
    FleetRouter  — prefix-affinity / least-loaded / round-robin
                   routing, role pools, exactly-once re-dispatch
                   (router.py)
    Replica      — one engine under the JOINING -> SERVING -> DRAINING
                   -> GONE lifecycle, health view, drain protocol
                   (replica.py)

The affinity signal is ``PrefixCache.affinity_summary`` matched against
``prefix_cache.prefix_fingerprints(prompt, ...)``; the drain contract is
``ServingEngine.close(drain=True, hand_back=True)``. The worker-process
fleet (``fleet.proc``: ``ProcServingFleet`` over spawned workers, one
engine and CUDA context each) is imported on demand, as in the JAX
package, and is kept out of this module's eager imports.
"""
from .fleet import ServingFleet  # noqa: F401
from .replica import (DRAINING, GONE, JOINING, ROLE_DECODE,  # noqa: F401
                      ROLE_GENERAL, ROLE_PREFILL, SERVING, Replica)
from .router import FleetRouter  # noqa: F401

__all__ = ["ServingFleet", "FleetRouter", "Replica", "JOINING",
           "SERVING", "DRAINING", "GONE", "ROLE_GENERAL",
           "ROLE_PREFILL", "ROLE_DECODE"]
