"""repro_torch.obs — the process-wide observability layer of the port.

The counterpart of the reference package's ``repro.obs``. One clock, one
span tracer, one metrics registry, one event log:

    from repro_torch import obs

    obs.clock.now()                       # THE monotonic clock
    with obs.trace.span("mode_update", mode=k):   # nested host spans
        ...
    obs.get_registry().inc("autotune.ec.memo_hits")
    obs.report()                          # process-wide JSON snapshot

A :class:`repro_torch.api.CPSolver` wraps a :class:`MetricsRegistry` of its
own and registers its report methods as named providers; long-lived
process-global state (autotune cache hit-rates, the plan cache, solver
registrations) lands in the registry :func:`get_registry` returns, which is
what :func:`report` snapshots. Span export (Chrome trace / Perfetto) lives
in :mod:`repro_torch.obs.export`; ``python -m repro_torch.obs TRACE.json``
validates an exported trace.
"""
from __future__ import annotations

from repro_torch.obs import clock, export, profiler, trace
from repro_torch.obs.metrics import EventLog, LogHistogram, MetricsRegistry
from repro_torch.obs.profiler import StreamMonitor

__all__ = ["clock", "trace", "export", "profiler",
           "LogHistogram", "MetricsRegistry", "EventLog", "StreamMonitor",
           "get_registry", "get_event_log", "report", "reset"]

_REGISTRY = MetricsRegistry()
_EVENTS = EventLog()


def get_registry() -> MetricsRegistry:
    """The process-global registry (autotune/plan-cache counters, solver
    provider registrations)."""
    return _REGISTRY


def get_event_log() -> EventLog:
    """The process-global event log (components without a session object
    of their own emit here)."""
    return _EVENTS


def report() -> dict:
    """One process-wide JSON snapshot: the global registry's counters,
    gauges, histograms and provider sections, plus the tracer's per-stage
    span summary."""
    out = _REGISTRY.report()
    out["trace"] = {"enabled": trace.get_tracer().enabled,
                    "spans": trace.get_tracer().summary()}
    return out


def reset() -> None:
    """Fresh global registry/event log and a cleared, disabled tracer —
    test isolation only; running components keep references to the old
    instances."""
    global _REGISTRY, _EVENTS
    _REGISTRY = MetricsRegistry()
    _EVENTS = EventLog()
    trace.reset()
