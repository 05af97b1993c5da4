"""Unified metrics registry: counters, gauges, log-bucketed histograms,
and a greppable JSON-lines event log (a copy of the reference package's
``obs/metrics.py``).

:class:`LogHistogram` is a latency histogram (log-spaced buckets,
O(buckets) memory, percentile exact to one bucket width) that locks itself:
``record`` and every read take the SAME lock, and percentiles/snapshots are
computed from ONE consistent copy of the bucket array, so a concurrent
``record`` mid-snapshot cannot yield a torn count/bucket view.

:class:`MetricsRegistry` is what every reporter registers into —
``CPSolver`` owns one whose named *providers*
(``overlap``/``exchange``/``imbalance``/``stream``) are the pre-existing
report methods, and the autotune/plan caches count hits into the process
registry (:func:`repro_torch.obs.get_registry`). ``report()`` is one
JSON-serializable snapshot of everything.

:class:`EventLog` is the structured, append-only twin of the registry: one
dict per event (``{"t", "wall", "kind", ...}``), kept in memory and —
when a sink is attached (``launch.decompose --events-out``) — mirrored as
one JSON line per event, flushed as written so ``grep '"kind": "sweep"'``
works on a live run.
"""
from __future__ import annotations

import json
import threading

import numpy as np

from repro_torch.obs import clock

__all__ = ["LogHistogram", "MetricsRegistry", "EventLog"]


class LogHistogram:
    """Fixed log-spaced histogram: ``lo`` → ``hi`` seconds at
    ``per_decade`` buckets per decade (defaults: 10 µs → ~100 s, 10 per
    decade). Percentile estimates are exact to one bucket width (≤ ~26%
    relative — plenty for p50/p99 dashboards) with O(buckets) memory
    regardless of traffic. Thread-safe: mutation and every read share one
    lock, so a snapshot is always a consistent count/bucket view."""

    LO, HI, PER_DECADE = 1e-5, 1e2, 10

    def __init__(self, lo: float | None = None, hi: float | None = None,
                 per_decade: int | None = None) -> None:
        lo = self.LO if lo is None else float(lo)
        hi = self.HI if hi is None else float(hi)
        per_decade = self.PER_DECADE if per_decade is None else int(per_decade)
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        ndec = int(np.log10(hi / lo))
        # bucket i covers [edges[i], edges[i+1]); +/- overflow buckets
        self.edges = np.logspace(np.log10(lo), np.log10(hi),
                                 ndec * per_decade + 1)
        self._lock = threading.Lock()
        self._counts = np.zeros(self.edges.size + 1, np.int64)  # guarded-by: _lock
        self._total_s = 0.0  # guarded-by: _lock

    @property
    def count(self) -> int:
        with self._lock:
            return int(self._counts.sum())

    def record(self, seconds: float) -> None:
        i = int(np.searchsorted(self.edges, seconds, "right"))
        with self._lock:
            self._counts[i] += 1
            self._total_s += seconds

    def _state(self) -> tuple[np.ndarray, float]:
        """One consistent (counts copy, total_s) pair."""
        with self._lock:
            return self._counts.copy(), float(self._total_s)

    def _percentile_of(self, counts: np.ndarray, q: float) -> float | None:
        total = int(counts.sum())
        if total == 0:
            return None
        cum = np.cumsum(counts)
        i = int(np.searchsorted(cum, q * total, "left"))
        if i == 0:
            return float(self.edges[0])
        if i >= self.edges.size:
            return float(self.edges[-1])
        return float(self.edges[i])

    def percentile(self, q: float) -> float | None:
        """Latency (seconds) at quantile ``q`` in [0, 1]; None when empty.
        Returns the upper edge of the bucket holding the q-th sample
        (a conservative — never understated — estimate)."""
        counts, _ = self._state()
        return self._percentile_of(counts, q)

    def snapshot(self) -> dict:
        counts, total_s = self._state()
        n = int(counts.sum())
        return {
            "count": n,
            "total_s": total_s,
            "mean_ms": (total_s / n * 1e3 if n else None),
            "p50_ms": _ms(self._percentile_of(counts, 0.50)),
            "p99_ms": _ms(self._percentile_of(counts, 0.99)),
        }


def _ms(seconds: float | None) -> float | None:
    return None if seconds is None else seconds * 1e3


class MetricsRegistry:
    """Counters + gauges + per-name :class:`LogHistogram`\\ s + named
    report providers, all behind one lock (histograms additionally carry
    their own — they are handed out and recorded into concurrently).
    Providers are zero-arg callables returning a JSON-serializable dict;
    they are invoked OUTSIDE the registry lock (a provider is free to take
    its component's own locks)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}   # guarded-by: _lock
        self._gauges: dict[str, object] = {}  # guarded-by: _lock
        self._hists: dict[str, LogHistogram] = {}  # guarded-by: _lock
        self._providers: dict[str, object] = {}    # guarded-by: _lock
        self._start = clock.now()

    # -- mutators ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def histogram(self, name: str, **kw) -> LogHistogram:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = LogHistogram(**kw)
            return hist

    def observe(self, name: str, seconds: float) -> None:
        self.histogram(name).record(seconds)

    class _Timer:
        def __init__(self, registry: "MetricsRegistry", name: str):
            self.registry, self.name = registry, name

        def __enter__(self):
            self.t0 = clock.now()
            return self

        def __exit__(self, *exc):
            self.registry.observe(self.name, clock.now() - self.t0)

    def time(self, name: str) -> "MetricsRegistry._Timer":
        """``with registry.time("reconstruct"): ...`` — records one latency
        sample on exit (exceptions included: a failed op still took
        time)."""
        return self._Timer(self, name)

    def register_provider(self, name: str, fn) -> None:
        """Attach a named report section (e.g. a solver's
        ``overlap_report``); ``report()`` snapshots call it."""
        with self._lock:
            self._providers[name] = fn

    def unregister_provider(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    # -- reads -------------------------------------------------------------
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def latency(self, name: str) -> dict | None:
        with self._lock:
            hist = self._hists.get(name)
        return None if hist is None else hist.snapshot()

    def snapshot(self) -> dict:
        """Plain-python copies of counters/gauges/latency histograms —
        the registry lock covers the scalar maps; each histogram snapshots
        under its own lock (internally consistent per histogram)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = list(self._hists.items())
        return {
            "counters": counters,
            "gauges": gauges,
            "latency": {name: h.snapshot() for name, h in hists},
        }

    def report(self) -> dict:
        """One JSON snapshot: uptime + counters/gauges/latency + every
        registered provider's section."""
        with self._lock:
            providers = list(self._providers.items())
        out = self.snapshot()
        out["uptime_s"] = clock.now() - self._start
        out["sections"] = {name: fn() for name, fn in providers}
        return out


class EventLog:
    """Append-only structured event list with an optional JSON-lines sink.

    ``emit(kind, **fields)`` stamps the event with the monotonic clock
    (``t``) and wall clock (``wall``) and appends it; with a sink attached
    the event is also written as one JSON line and flushed. ``payloads``
    strips the bookkeeping keys back off, so views built over the log are
    value-identical to the plain dict lists they replaced."""

    _STAMPS = ("t", "wall", "kind")

    def __init__(self, sink_path: str | None = None) -> None:
        self._lock = threading.Lock()
        self._events: list[dict] = []  # guarded-by: _lock
        self._sink = None              # guarded-by: _lock
        if sink_path is not None:
            self.set_sink(sink_path)

    def emit(self, kind: str, **fields) -> dict:
        event = {"t": clock.now(), "wall": clock.walltime(), "kind": kind,
                 **fields}
        line = json.dumps(event, default=str)
        with self._lock:
            self._events.append(event)
            if self._sink is not None:
                self._sink.write(line + "\n")
                self._sink.flush()
        return event

    def set_sink(self, path: str) -> None:
        """Attach (or replace) a JSON-lines file sink; events already in
        memory are written first, so a sink attached mid-run still holds
        the full log."""
        sink = open(path, "w")
        with self._lock:
            for event in self._events:
                sink.write(json.dumps(event, default=str) + "\n")
            sink.flush()
            old, self._sink = self._sink, sink
        if old is not None:
            old.close()

    def close_sink(self) -> None:
        with self._lock:
            old, self._sink = self._sink, None
        if old is not None:
            old.close()

    def events(self, kind: str | None = None) -> list[dict]:
        """Stamped events (all, or one kind), in emission order."""
        with self._lock:
            events = list(self._events)
        if kind is None:
            return events
        return [e for e in events if e["kind"] == kind]

    def payloads(self, kind: str) -> list[dict]:
        """The events of one kind with the stamp keys removed — exactly
        the dicts the emitter passed in."""
        return [{k: v for k, v in e.items() if k not in self._STAMPS}
                for e in self.events(kind)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
