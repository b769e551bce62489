"""Runtime evidence for the serving stack (port of
``paddle_tpu/observability``).

    SpanTracer       — thread-safe bounded-ring span tracer; Chrome-
                       trace/Perfetto export, one track per engine
                       phase and one per serving slot (tracer.py)
    FlightRecorder   — last-N-ticks ring + JSON postmortem dumped
                       automatically on KVInvariantError or an
                       engine-loop crash (flight.py)
    RecompileSentinel— kernel-library load listener: any load after
                       warmup becomes a labeled WARN metric, a named
                       span and a RecompileWarning, reported beside the
                       engine's expected library inventory
                       (sentinel.py)

Wired through ``serving.ServingEngine`` (``trace=``, ``flight_ticks=``,
``flight_dir=``, ``recompile_sentinel=``; on by default). The JAX
package's ``bridge_record_events`` mirrors ``paddle_tpu.profiler``
spans and waits for the port's profiler; the engine's device-trace
annotations are ``torch.profiler.record_function`` ranges meanwhile.
"""
from .flight import FlightRecorder, default_flight_dir  # noqa: F401
from .sentinel import (COMPILE_EVENT, RECOMPILES_METRIC,  # noqa: F401
                       RecompileSentinel, RecompileWarning)
from .tracer import Span, SpanTracer, current_span  # noqa: F401

__all__ = ["SpanTracer", "Span", "current_span", "FlightRecorder",
           "default_flight_dir", "RecompileSentinel", "RecompileWarning",
           "COMPILE_EVENT", "RECOMPILES_METRIC"]
