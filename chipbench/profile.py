"""``torch.profiler`` windows and the arithmetic over their device trace.

A window is a few steps run under the profiler (CPU and CUDA activities),
inside one ``record_function`` scope named :data:`WINDOW` that ends in a
synchronise of every card. Its Chrome trace is read back as
:class:`Event` records whose host and device times share one clock.

Device work is what runs on a card: kernels, copies and memsets. A card's
busy time is the union of its work intervals; the device-side annotation
ranges are not work. An idle gap is named by the host scopes open at its
midpoint, innermost first.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

__all__ = ["WINDOW", "Event", "capture", "merged", "clip", "window",
           "cards", "busy", "busy_within", "busiest_card_within",
           "host_intervals", "ops_within", "top_ops", "idle_gaps"]

WINDOW = "profiled_window"
DEVICE_WORK = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_SCOPES = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                         "cuda_driver"})


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    t0: int          # ns
    t1: int          # ns
    cat: str
    card: int | None  # the card of device work, else None

    @property
    def device_work(self) -> bool:
        return self.cat in DEVICE_WORK


def capture(step, count: int, sync, *, cuda: bool = True) -> list[Event]:
    """``step()`` ``count`` times under the profiler, each in a scope
    named ``"step k"``, all in the :data:`WINDOW` scope that ends with
    ``sync()``; the trace's complete events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for k in range(count):
                with record_function(f"step {k}"):
                    step()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = []
    for e in raw:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat"))
        card = None
        if cat in DEVICE_WORK:
            card = int(e.get("args", {}).get("device", e.get("pid", 0)))
        t0 = int(round(1e3 * float(e["ts"])))
        out.append(Event(e["name"], t0,
                         t0 + int(round(1e3 * float(e["dur"]))), cat, card))
    return out


def merged(intervals) -> list[list[int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clip(intervals, within) -> list[list[int]]:
    """The parts of ``intervals`` inside the union of ``within``, merged."""
    spans = merged(within)
    out = []
    for a, b in merged(intervals):
        for c, d in spans:
            lo, hi = max(a, c), min(b, d)
            if lo < hi:
                out.append([lo, hi])
    return merged(out)


def window(events) -> tuple[int, int]:
    return next((e.t0, e.t1) for e in events
                if e.name == WINDOW and e.cat in HOST_SCOPES)


def cards(events) -> list[int]:
    return sorted({e.card for e in events if e.device_work})


def busy(events, card: int) -> list[list[int]]:
    """The card's merged work intervals inside the window."""
    w0, w1 = window(events)
    return clip([(e.t0, e.t1) for e in events
                 if e.device_work and e.card == card], [(w0, w1)])


def host_intervals(events, name: str) -> list[tuple[int, int]]:
    """The host intervals of the scopes called ``name``."""
    return [(e.t0, e.t1) for e in events
            if e.name == name and e.cat in HOST_SCOPES]


def busy_within(events, card: int, spans, *, cats=DEVICE_WORK,
                names=None) -> int:
    """ns in which ``card`` runs work of ``cats`` (and, given ``names``,
    whose name holds one of them) inside the union of ``spans``."""
    ivs = [(e.t0, e.t1) for e in events
           if e.cat in cats and e.card == card
           and (names is None or any(n in e.name for n in names))]
    return sum(b - a for a, b in clip(ivs, spans))


def top_ops(events, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time in the window,
    summed over cards: ``[name, seconds]``."""
    w0, w1 = window(events)
    tot: dict[str, float] = {}
    for e in events:
        if e.device_work and e.t1 > w0 and e.t0 < w1:
            tot[e.name] = tot.get(e.name, 0.0) \
                + (min(e.t1, w1) - max(e.t0, w0)) / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def ops_within(events, span: str, n: int = 8) -> list[list]:
    """The ``n`` device operations that took most time inside the host
    scopes named ``span``, summed over cards: ``[name, seconds]``."""
    spans = merged(host_intervals(events, span))
    tot: dict[str, float] = {}
    for e in events:
        if e.device_work:
            ns = sum(b - a for a, b in clip([(e.t0, e.t1)], spans))
            if ns:
                tot[e.name] = tot.get(e.name, 0.0) + ns / 1e9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _scopes(host, t: int) -> list[str]:
    return [e.name for e in sorted((e for e in host if e.t0 <= t <= e.t1),
                                   key=lambda e: e.t1 - e.t0)]


def idle_gaps(events, n: int = 10) -> list[list]:
    """The ``n`` longest idle gaps of any card in the window, each named
    by its card and the (at most three) innermost host scopes open at its
    midpoint: ``[name, seconds]``."""
    w0, w1 = window(events)
    host = [e for e in events if e.cat in HOST_SCOPES and e.name != WINDOW]
    gaps = []
    for c in cards(events):
        edges = [w0] + [x for ab in busy(events, c) for x in ab] + [w1]
        gaps += [(edges[i + 1] - edges[i], c, edges[i], edges[i + 1])
                 for i in range(0, len(edges) - 1, 2)
                 if edges[i + 1] > edges[i]]
    out = []
    for g, c, a, b in sorted(gaps, reverse=True)[:n]:
        scope = " < ".join(_scopes(host, (a + b) // 2)[:3]) or "(no host op)"
        out.append([f"cuda:{c} {scope}", g / 1e9])
    return out


def busiest_card_within(events, span: str, **kw) -> int | None:
    """ns of work of the busiest card inside the host scopes named
    ``span``; None when the window holds no such scope or no device
    work."""
    spans = host_intervals(events, span)
    found = cards(events)
    if not spans or not found:
        return None
    return max(busy_within(events, c, spans, **kw) for c in found)
