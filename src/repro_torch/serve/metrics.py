"""Service observability: counters, gauges, latency histograms.

The counterpart of the reference package's ``serve/metrics.py``: one
JSON-serializable :meth:`ServiceMetrics.metrics_report` carrying everything
an operator watches — query/reject/error counters, per-operation latency
percentiles (p50/p99 from log-spaced histograms, O(1) memory per op),
current queue depth, the published snapshot's version and age, and a
refit-in-progress gauge.

A thin view over :class:`repro_torch.obs.MetricsRegistry`: the
counters/gauges/histograms live in the registry (one per service,
injectable for sharing), and ``metrics_report()`` has the reference's keys.
``LatencyHistogram`` is the serving name for
:class:`repro_torch.obs.LogHistogram` at its default 10 µs → ~100 s
geometry; every mutator is thread-safe (queries arrive from many client
threads, refits from a background thread) and snapshots are taken under the
same locks as the recording paths.
"""
from __future__ import annotations

from repro_torch.obs import clock
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry

__all__ = ["LatencyHistogram", "ServiceMetrics"]

# the serving name; identical default bucket geometry
LatencyHistogram = LogHistogram


class ServiceMetrics:
    """Counters + gauges + per-operation :class:`LatencyHistogram`\\ s —
    a named view over a :class:`~repro_torch.obs.MetricsRegistry` (pass one
    to share it with other components; by default each service owns its
    own)."""

    def __init__(self, registry: MetricsRegistry | None = None) -> None:
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._start = clock.now()

    # -- mutators ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.registry.inc(name, n)

    def set_gauge(self, name: str, value) -> None:
        self.registry.set_gauge(name, value)

    def observe(self, op: str, seconds: float) -> None:
        self.registry.observe(op, seconds)

    def time(self, op: str):
        """``with metrics.time("reconstruct"): ...`` — records one latency
        sample on exit (exceptions included: a failed query still took
        time)."""
        return self.registry.time(op)

    # -- reads -------------------------------------------------------------
    def counter(self, name: str) -> int:
        return self.registry.counter(name)

    def gauge(self, name: str, default=None):
        return self.registry.gauge(name, default)

    def latency(self, op: str) -> dict | None:
        return self.registry.latency(op)

    def metrics_report(self) -> dict:
        """The JSON ``python -m repro_torch.serve`` prints: uptime, qps over
        the process lifetime, all counters/gauges, and per-op latency
        percentiles."""
        snap = self.registry.snapshot()
        uptime = clock.now() - self._start
        queries = snap["counters"].get("queries_total", 0)
        return {
            "uptime_s": uptime,
            "qps": queries / uptime if uptime > 0 else 0.0,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "latency": snap["latency"],
        }
