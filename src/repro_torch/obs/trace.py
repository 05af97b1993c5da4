"""Process-wide span tracer: nested host-side spans on the monotonic clock.

A copy of the reference package's ``obs/trace.py``, with a second sink.
One global :class:`Tracer` (``get_tracer()``) collects begin/end intervals
("spans") from every layer — plan → compile → run → sweep → shards /
mode_update → ec (ec.args, ec.kernel) / exchange / solve ⊃ eigh → fit,
the H2D window and the rebalance probe — with a
THREAD-LOCAL span stack, so spans opened on the streamer's prefetch thread
nest under that thread's own roots instead of corrupting the main
thread's tree.

    from repro_torch.obs import trace
    with trace.span("mode_update", mode=d, annotate=True):
        with trace.span("ec", mode=d, annotate=True, sync=mesh.devices):
            ...

A span goes to one of two sinks, or to none:

* **Tracer on**: it records ``{id, parent, name, tid, t0, t1, attrs}`` on
  the shared :func:`repro_torch.obs.clock.now` clock; ``annotate=True``
  also enters :func:`repro_torch.obs.profiler.annotation` (a
  ``torch.profiler.record_function`` scope, and an NVTX range where CUDA
  is available), so a ``torch.profiler`` trace of the card lines up with
  the host spans. ``sync=devices`` synchronises those cards (CPU devices
  are skipped) before the span stamps its end, inside the annotation: a
  stage's span then ends when its device work does.
* **Tracer off, a** ``torch.profiler`` **recording** (the autograd
  profiler's module flag ``_is_profiler_enabled``): an ``annotate=True``
  span enters only its ``record_function`` scope. It records nothing and
  synchronises nothing, so a profile of the untraced program carries its
  stages as host events on the clock of the device events.
* **Neither**: the shared no-op context manager — one attribute check and
  one module-global read, no allocation beyond the kwargs dict — so
  instrumented hot paths cost nothing measurable. (A ``record_function``
  scope costs about 11 µs on the CPU even with no profiler running, which
  is why the profiler's flag is read first.)

Export to Chrome-trace/Perfetto JSON lives in :mod:`repro_torch.obs.export`
(``CPSolver.dump_trace`` / ``launch.decompose --trace-out``).
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import clock

__all__ = ["Tracer", "get_tracer", "span", "enable", "disable", "reset"]


class _NullSpan:
    """Shared no-op context manager handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "id", "parent", "t0", "t1",
                 "_annotation", "_sync")

    def __init__(self, tracer: "Tracer", name: str, annotate: bool,
                 sync, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = self.parent = None
        self.t0 = self.t1 = None
        self._annotation = None
        self._sync = sync
        if annotate:
            from repro_torch.obs import profiler
            self._annotation = profiler.annotation(name)

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self._tracer._ids)
        stack.append(self)
        if self._annotation is not None:
            self._annotation.__enter__()
        self.t0 = clock.now()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            for card in {d for d in self._sync if d.type == "cuda"}:
                torch.cuda.synchronize(card)
        self.t1 = clock.now()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record({
            "id": self.id, "parent": self.parent, "name": self.name,
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
            "t0": self.t0, "t1": self.t1, "attrs": self.attrs,
        })
        return False

    @property
    def duration(self) -> Optional[float]:
        return None if self.t0 is None or self.t1 is None \
            else self.t1 - self.t0


class Tracer:
    """Span collector with thread-local stacks; disabled by default."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: list[dict] = []  # guarded-by: _lock
        self._ids = itertools.count()
        self._tls = threading.local()
        # read unlocked on the hot path: a torn read costs one span at an
        # enable/disable edge, never a corrupt record
        self._enabled = False

    # -- hot path ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def span(self, name: str, *, annotate: bool = False, sync=None,
             **attrs):
        """Context manager for one span (see the module docstring for its
        sinks). ``sync`` is an iterable of ``torch.device``: with the
        tracer on, their cards are synchronised before the span ends."""
        if not self._enabled:
            if annotate and _autograd_profiler._is_profiler_enabled:
                return torch.profiler.record_function(name)
            return _NULL_SPAN
        return _Span(self, name, annotate, sync, attrs)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)

    # -- control / reads ---------------------------------------------------
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def records(self) -> list[dict]:
        """Finished spans, in completion order (children before parents)."""
        with self._lock:
            return list(self._records)

    def summary(self) -> dict:
        """``{name: {"count", "total_s"}}`` over the finished spans — the
        deterministic per-stage numbers the bench bakes into its artifact."""
        out: dict[str, dict] = {}
        for r in self.records():
            s = out.setdefault(r["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += r["t1"] - r["t0"]
        return out


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every repro_torch module records into."""
    return _TRACER


# ``with trace.span("mode_update", mode=k): ...`` on the global tracer: its
# bound method itself, so that a span the hot path opens with tracing off
# costs one Python call, not two
span = _TRACER.span


def enable() -> None:
    _TRACER.enable()


def disable() -> None:
    _TRACER.disable()


def reset() -> None:
    """Disable and drop all recorded spans (test isolation)."""
    _TRACER.disable()
    _TRACER.clear()
