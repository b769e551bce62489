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
``flight_dir=``, ``recompile_sentinel=``; on by default).
``bridge_record_events`` mirrors every closing ``profiler.RecordEvent``
span (the engine's ``serving.tick``, ``serving.decode_step`` and
``serving.admit`` among them) into a ``SpanTracer``.
"""
from .flight import FlightRecorder, default_flight_dir  # noqa: F401
from .sentinel import (COMPILE_EVENT, RECOMPILES_METRIC,  # noqa: F401
                       RecompileSentinel, RecompileWarning)
from .tracer import Span, SpanTracer, current_span  # noqa: F401

__all__ = ["SpanTracer", "Span", "current_span", "FlightRecorder",
           "default_flight_dir", "RecompileSentinel", "RecompileWarning",
           "COMPILE_EVENT", "RECOMPILES_METRIC", "bridge_record_events"]


def bridge_record_events(tracer: SpanTracer, track: str = "profiler"):
    """Mirror every closing ``profiler.RecordEvent`` span into
    ``tracer`` on one ``track``: the device-trace annotations and the
    serving engine's own spans then read in the same Perfetto export.
    Returns a zero-arg detach callable."""
    from .. import profiler

    def _sink(name, t0_s, t1_s):
        tracer.add(name, track, t0_s, t1_s)

    profiler.add_span_sink(_sink)

    def detach():
        profiler.remove_span_sink(_sink)
    return detach
