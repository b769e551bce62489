"""Multi-process serving fleet: launcher, RPC transport, KV migration.

Port of ``paddle_tpu/serving/fleet/proc``. The in-process fleet
(serving/fleet/) proved the contracts on one GIL; this package runs the
SAME router and lifecycle over spawned worker processes, each owning a
full ServingEngine on its own PyTorch runtime and CUDA context:

* :class:`WorkerSpec` / wire.py — the pickled spawn spec and the frame
  schema (everything that crosses the boundary, in one file: plain data
  and numpy, never a tensor);
* :class:`WorkerTransport` — rpc with timeouts, streamed token frames
  with enforced ordering, crash detection that drains in-flight frames
  before declaring death;
* :class:`ProcReplica` — the Replica surface over the transport, with
  parent-side Requests staying authoritative (handles survive
  re-dispatch; emission dedup pins exactly-once delivery);
* :class:`ProcServingFleet` — launcher/supervisor: concurrent
  bring-up, generation-bumped membership, drain-on-failure for hard
  crashes, merged Prometheus scrape from per-worker scrape text, and
  fingerprint-keyed KV-page migration between workers.

A worker runs on the card unless its spec names ``device="cpu"``.
"""
from .fleet import ProcServingFleet
from .replica import ProcReplica
from .transport import (TransportError, TransportTimeout, WorkerDied,
                        WorkerTransport)
from .wire import WorkerSpec, request_from_wire, request_to_wire

__all__ = ["ProcServingFleet", "ProcReplica", "WorkerTransport",
           "WorkerSpec", "TransportError", "TransportTimeout",
           "WorkerDied", "request_to_wire", "request_from_wire"]
