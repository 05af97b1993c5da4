"""Chrome-trace / Perfetto export and schema validation of tracer spans
(a copy of the reference package's ``obs/export.py``: a trace exported by
either package passes the other's validator).

``chrome_trace`` turns :class:`repro_torch.obs.trace.Tracer` records into the
Trace Event Format both ``chrome://tracing`` and https://ui.perfetto.dev
load directly: paired ``ph: "B"``/``ph: "E"`` duration events per span,
one track per (pid, tid), timestamps in microseconds relative to the
earliest span. Events are emitted in depth-first tree order per thread
(parents' B before children's B, children's E before parents' E), which is
exactly the nesting contract the viewers — and :func:`validate_trace` —
reconstruct from event order.

``validate_trace`` is the schema gate: every B paired with an E, sibling spans monotone and
non-overlapping, children inside their parents, and the union of top-level
spans covering at least ``min_coverage`` of the traced wall time.
"""
from __future__ import annotations

import json
import os

__all__ = ["chrome_trace", "dump_chrome_trace", "validate_trace",
           "validate_trace_file", "span_counts"]

# sibling/parent containment slack (seconds): clock reads inside __enter__/
# __exit__ are ordered, so this only absorbs float rounding in µs export
_EPS = 1e-6


def chrome_trace(records: list[dict], *, pid: int | None = None) -> dict:
    """Tracer records → ``{"traceEvents": [...], "displayTimeUnit": "ms"}``
    with paired B/E events in depth-first order per thread."""
    if pid is None:
        pid = os.getpid()
    events: list[dict] = []
    if records:
        t_zero = min(r["t0"] for r in records)
        by_id = {r["id"]: r for r in records}
        children: dict[object, list[dict]] = {}
        for r in records:
            parent = r["parent"] if r["parent"] in by_id else None
            children.setdefault(parent, []).append(r)
        for sibs in children.values():
            sibs.sort(key=lambda r: (r["t0"], r["id"]))

        def us(t: float) -> float:
            return (t - t_zero) * 1e6

        def emit(rec: dict) -> None:
            base = {"name": rec["name"], "cat": "repro",
                    "pid": pid, "tid": rec["tid"]}
            events.append({**base, "ph": "B", "ts": us(rec["t0"]),
                           "args": dict(rec["attrs"])})
            for child in children.get(rec["id"], ()):
                emit(child)
            events.append({**base, "ph": "E", "ts": us(rec["t1"])})

        for root in children.get(None, ()):
            emit(root)
        tids = {r["tid"]: r.get("thread", str(r["tid"])) for r in records}
        for tid, tname in sorted(tids.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path: str, records: list[dict]) -> dict:
    """Write ``chrome_trace(records)`` as JSON; returns the trace dict."""
    trace = chrome_trace(records)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def _merged_coverage(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [t0, t1) intervals."""
    covered = 0.0
    end = None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            covered += t1 - t0
            end = t1
        elif t1 > end:
            covered += t1 - end
            end = t1
    return covered


def validate_trace(trace: dict, *, min_coverage: float = 0.95) -> dict:
    """Schema-check a Chrome-trace dict. Returns ``{"ok", "problems",
    "wall_us", "coverage", "span_counts"}``; ``ok`` is False when any B/E
    is unpaired, a sibling overlaps or runs backwards, a child escapes its
    parent, or top-level coverage falls below ``min_coverage``."""
    problems: list[str] = []
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") in ("B", "E")]
    if not events:
        return {"ok": False, "problems": ["no B/E events"], "wall_us": 0.0,
                "coverage": 0.0, "span_counts": {}}
    eps_us = _EPS * 1e6
    counts: dict[str, int] = {}
    top_level: list[tuple[float, float]] = []
    by_tid: dict[object, list[dict]] = {}
    for e in events:
        by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for tid, seq in sorted(by_tid.items(), key=lambda kv: str(kv[0])):
        # stack entries: [name, ts_begin, end_of_previous_child]
        stack: list[list] = []
        last_top_end = None
        for e in seq:
            if e["ph"] == "B":
                if not stack and last_top_end is not None \
                        and e["ts"] < last_top_end - eps_us:
                    problems.append(
                        f"tid {tid}: top-level span {e['name']!r} overlaps "
                        f"the previous top-level span")
                if stack:
                    parent = stack[-1]
                    if e["ts"] < parent[1] - eps_us:
                        problems.append(
                            f"tid {tid}: span {e['name']!r} begins before "
                            f"its parent {parent[0]!r}")
                    if parent[2] is not None and e["ts"] < parent[2] - eps_us:
                        problems.append(
                            f"tid {tid}: sibling {e['name']!r} overlaps the "
                            f"previous sibling (begins at {e['ts']:.1f} µs "
                            f"before it ended at {parent[2]:.1f} µs)")
                stack.append([e["name"], e["ts"], None])
            else:  # "E"
                if not stack:
                    problems.append(f"tid {tid}: E event {e['name']!r} "
                                    f"without a matching B")
                    continue
                name, t0, _ = stack.pop()
                if name != e["name"]:
                    problems.append(f"tid {tid}: E event {e['name']!r} "
                                    f"closes span {name!r}")
                if e["ts"] < t0 - eps_us:
                    problems.append(f"tid {tid}: span {name!r} ends before "
                                    f"it begins")
                counts[name] = counts.get(name, 0) + 1
                if stack:
                    stack[-1][2] = e["ts"]
                else:
                    last_top_end = e["ts"]
                    top_level.append((t0, e["ts"]))
        for name, _, _ in stack:
            problems.append(f"tid {tid}: B event {name!r} never closed")
    wall = (max(e["ts"] for e in events) - min(e["ts"] for e in events))
    coverage = _merged_coverage(top_level) / wall if wall > 0 else 1.0
    if coverage < min_coverage:
        problems.append(f"top-level span coverage {coverage:.1%} < "
                        f"{min_coverage:.0%} of wall time")
    return {"ok": not problems, "problems": problems, "wall_us": wall,
            "coverage": coverage, "span_counts": counts}


def validate_trace_file(path: str, *, min_coverage: float = 0.95) -> dict:
    with open(path) as f:
        return validate_trace(json.load(f), min_coverage=min_coverage)


def span_counts(records: list[dict]) -> dict[str, int]:
    """``{name: count}`` straight from tracer records (no export round
    trip)."""
    out: dict[str, int] = {}
    for r in records:
        out[r["name"]] = out.get(r["name"], 0) + 1
    return out
