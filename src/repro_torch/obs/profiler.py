"""``torch.profiler`` integration: host spans that line up with device
profiles, plus the per-window transfer-stall monitor.

The counterpart of the reference package's ``obs/profiler.py``:

* :func:`annotation` — a ``torch.profiler.record_function`` scope: the
  host-side interval shows up on a ``torch.profiler`` trace's CPU track,
  nested exactly like the spans, and the device work launched inside it is
  attributed to it. Where CUDA is available it also pushes an NVTX range
  (``torch.cuda.nvtx``) for external timeline tools. A CPU-only torch has
  no NVTX and raises on it, so there the range is skipped; nothing is
  computed differently.
* :class:`StreamMonitor` — joins the streamer's per-window ``h2d_build`` /
  ``h2d_wait`` events into a per-window exposed-vs-hidden stall
  attribution: ``exposed_s`` is what the consumer actually blocked on,
  ``hidden_s`` the rest of that window's transfer, which double buffering
  hid behind compute.
"""
from __future__ import annotations

import torch

__all__ = ["annotation", "StreamMonitor"]


class _Annotation:
    """``record_function(name)``, inside an NVTX range where CUDA is
    available."""

    __slots__ = ("_name", "_scope", "_nvtx")

    def __init__(self, name: str):
        self._name = name
        self._scope = torch.profiler.record_function(name)
        self._nvtx = torch.cuda.is_available()

    def __enter__(self):
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        self._scope.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def annotation(name: str) -> _Annotation:
    """Host-side profiler annotation context."""
    return _Annotation(name)


class StreamMonitor:
    """Per-window transfer-stall attribution from streamer span data.

    The streamer emits one ``h2d_build`` event per window materialization
    (``build_s`` = full host→device transfer time, on the prefetch thread)
    and one ``h2d_wait`` event per exposed wait (``wait_s`` = how long
    ``get()`` blocked, on the consumer thread). A window's exposed stall is
    the wait time attributed to its most recent build; the remainder of the
    build is hidden behind compute. Totals reconcile with the streamer's
    aggregate ``transfer_s``/``exposed_s`` counters by construction."""

    def __init__(self, events) -> None:
        self._events = events

    def windows(self) -> list[dict]:
        """One record per window build, in build order: ``{key, mode,
        shard, transfer_s, exposed_s, hidden_s}``."""
        out: list[dict] = []
        latest: dict[tuple, dict] = {}
        for e in self._events.events():
            if e["kind"] == "h2d_build":
                key = (e.get("mode"), e.get("shard"))
                rec = {"mode": e.get("mode"), "shard": e.get("shard"),
                       "transfer_s": float(e["build_s"]), "exposed_s": 0.0}
                latest[key] = rec
                out.append(rec)
            elif e["kind"] == "h2d_wait":
                key = (e.get("mode"), e.get("shard"))
                rec = latest.get(key)
                if rec is None:
                    # a wait with no recorded build (e.g. events attached
                    # mid-run): account it as a zero-transfer window
                    rec = {"mode": e.get("mode"), "shard": e.get("shard"),
                           "transfer_s": 0.0, "exposed_s": 0.0}
                    latest[key] = rec
                    out.append(rec)
                rec["exposed_s"] += float(e["wait_s"])
        for rec in out:
            rec["hidden_s"] = max(rec["transfer_s"] - rec["exposed_s"], 0.0)
        return out

    def report(self) -> dict:
        """Aggregate + per-window attribution: which windows' transfers
        were exposed (the consumer stalled) vs hidden behind compute."""
        windows = self.windows()
        transfer = sum(w["transfer_s"] for w in windows)
        exposed = sum(min(w["exposed_s"], w["transfer_s"]) for w in windows)
        stalled = [w for w in windows
                   if w["transfer_s"] > 0
                   and w["exposed_s"] > 0.5 * w["transfer_s"]]
        return {
            "windows": windows,
            "num_windows": len(windows),
            "transfer_s": transfer,
            "exposed_s": exposed,
            "hidden_s": max(transfer - exposed, 0.0),
            "stalled_windows": len(stalled),
        }
