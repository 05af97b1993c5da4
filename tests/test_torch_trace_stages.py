"""The port's stage spans on the CPU (``repro_torch.obs.trace``).

One span mechanism with two sinks: with the tracer on a span is recorded
(and ``sync=`` waits for its cards before it ends); with the tracer off an
annotated span is a bare ``torch.profiler`` scope while a profiler
records, and the shared no-op otherwise. A sweep runs one path, traced or
not: sweep → {shards, mode_update → {ec → {ec.args, ec.kernel}, exchange,
solve → eigh}, fit}, with the untraced run's bits on every EC variant, and
the exchange no longer holds the solve (also streamed).
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.export import chrome_trace, validate_trace  # noqa: E402
from repro_torch.store import TensorStore, write_store_from_coo  # noqa: E402

CPU = torch.profiler.ProfilerActivity.CPU
CARDS = [torch.device("cuda", 0), torch.device("cuda", 1),
         torch.device("cuda", 0), torch.device("cpu")]
VARIANTS = ["sorted", "fused", "blocked", "ref"]
EC_STAGES = {"ref": ["ec.kernel"]}
SWEEPS = 2
# The sweeps over which a traced run's top-level coverage is judged. The
# gap between ``compile`` and ``run`` holds a fraction of a millisecond of
# program work, but a pause of the host there (a garbage collection, or
# the process descheduled in a parallel test run) once took 31 % of a
# two-sweep run's wall time, 44 ms. Over this many sweeps the fastest
# variant's spans take ~0.3 s alone and several times that under such a
# load, so no one pause of that size decides the 95 %.
COVERAGE_SWEEPS = 128


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    yield
    obs.reset()


def _host_scopes(prof, tmp_path) -> list[dict]:
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


# -- the span's sinks --------------------------------------------------------

def test_annotated_span_is_a_bare_profiler_scope_with_the_tracer_off(
        tmp_path, monkeypatch):
    """Tracer off, profiler on: an annotated span is a ``user_annotation``
    scope of the profile and nothing else (no record, no synchronise); a
    span without ``annotate`` stays the shared no-op."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    with torch.profiler.profile(activities=[CPU]) as prof:
        with obs_trace.span("stage", annotate=True, sync=CARDS, mode=1):
            torch.ones(8).sum()
        assert obs_trace.span("bare", sync=CARDS) is obs_trace._NULL_SPAN
    stage = [e for e in _host_scopes(prof, tmp_path) if e["name"] == "stage"]
    assert [e["cat"] for e in stage] == ["user_annotation"]
    assert obs_trace.get_tracer().records() == []
    assert calls == []


def test_span_is_the_shared_noop_with_neither_sink():
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = [obs_trace.span("a", annotate=True),
             obs_trace.span("b", annotate=True, sync=CARDS, mode=0),
             obs_trace.get_tracer().span("c")]
    assert all(s is obs_trace._NULL_SPAN for s in spans)
    with spans[1]:
        pass
    assert obs_trace.get_tracer().records() == []


def test_sync_waits_for_each_card_before_the_span_ends(monkeypatch):
    """``sync=`` synchronises each distinct card once, skipping the CPU,
    only with the tracer on, and before the span stamps its end; it is not
    an attribute of the record."""
    calls = []

    def synchronize(card):
        time.sleep(0.02)
        calls.append(card)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    with obs_trace.span("off", sync=CARDS):
        pass
    assert calls == []
    obs_trace.enable()
    with obs_trace.span("on", annotate=True, sync=CARDS, mode=2):
        assert calls == []
    assert sorted(calls, key=str) == [torch.device("cuda", 0),
                                      torch.device("cuda", 1)]
    rec, = obs_trace.get_tracer().records()
    assert rec["attrs"] == {"mode": 2}
    assert rec["t1"] - rec["t0"] >= 0.04


# -- the sweep's stages ------------------------------------------------------

def _cfg(trace, variant, **over):
    return api.preset("paper", {
        "rank": 4, "runtime.num_devices": 1, "runtime.tol": 0.0,
        "runtime.seed": 0, "runtime.trace": trace,
        "kernel.variant": variant, "kernel.autotune": False,
        "partition.layout": "sorted" if variant == "sorted" else "blocked",
        **over})


def _run(t, cfg, sweeps=SWEEPS):
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        return s.run(sweeps)


def _children(records) -> dict:
    """``{id: [child names in start order]}``, and ``None`` for roots."""
    out: dict = {}
    for r in sorted(records, key=lambda r: (r["t0"], r["id"])):
        out.setdefault(r["parent"], []).append(r["name"])
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_traced_run_records_every_stage_with_the_untraced_bits(variant):
    """Each sweep and mode records the whole tree of stages, the exchange
    and the solve apart, at ≥ 95 % coverage over ``COVERAGE_SWEEPS``
    sweeps, and the traced run's fits and factors are the untraced run's
    bitwise."""
    t = random_sparse((30, 20, 10), 600, seed=1)
    plain = _run(t, _cfg(False, variant), COVERAGE_SWEEPS)
    traced = _run(t, _cfg(True, variant), COVERAGE_SWEEPS)
    assert traced.fits == plain.fits
    for a, b in zip(plain.factors, traced.factors):
        np.testing.assert_array_equal(a, b)

    records = obs_trace.get_tracer().records()
    res = validate_trace(chrome_trace(records), min_coverage=0.95)
    assert res["ok"], res["problems"]
    kids = _children(records)
    leaves = {"shards", "exchange", "eigh", "fit", "ec.args", "ec.kernel"}
    ec = EC_STAGES.get(variant, ["ec.args", "ec.kernel"])
    n = t.nmodes
    seen = {"sweep": 0, "mode_update": 0}
    for r in records:
        got = kids.get(r["id"], [])
        if r["name"] == "run":
            assert got == ["sweep"] * COVERAGE_SWEEPS
        elif r["name"] == "sweep":
            assert got == ["shards"] + ["mode_update"] * n + ["fit"]
        elif r["name"] == "mode_update":
            assert got == ["ec", "exchange", "solve"]
        elif r["name"] == "ec":
            assert got == ec
        elif r["name"] == "solve":
            assert got == ["eigh"] and r["attrs"]["device"] == 0
        else:
            assert r["name"] in leaves | {"compile"} and not got, r
        seen[r["name"]] = seen.get(r["name"], 0) + 1
    assert seen["sweep"] == COVERAGE_SWEEPS
    assert all(seen[name] == n * COVERAGE_SWEEPS for name in
               ("mode_update", "ec", "exchange", "solve", "eigh", *ec))


def test_profiled_untraced_run_carries_the_stages_as_scopes():
    """Tracer off under ``torch.profiler``: every stage is a host scope of
    the profile, once per mode and sweep, nothing is recorded, and the
    bits are the unprofiled run's."""
    t = random_sparse((30, 20, 10), 600, seed=1)
    cfg = _cfg(False, "sorted")
    plain = _run(t, cfg)
    with torch.profiler.profile(activities=[CPU]) as prof:
        profiled = _run(t, cfg)
    assert profiled.fits == plain.fits
    counts: dict = {}
    for e in prof.events():
        counts[e.name] = counts.get(e.name, 0) + 1
    per_mode = ("mode_update", "ec", "ec.args", "ec.kernel", "exchange",
                "solve", "eigh")
    assert {k: counts.get(k) for k in ("sweep", "shards", "fit")} == \
        dict.fromkeys(("sweep", "shards", "fit"), SWEEPS)
    assert {k: counts.get(k) for k in per_mode} == \
        dict.fromkeys(per_mode, t.nmodes * SWEEPS)
    assert obs_trace.get_tracer().records() == []


def test_streamed_traced_run_solves_outside_the_exchange(tmp_path):
    """A streamed sweep's exchange span holds the merge and gather alone;
    each replica's solve is a sibling, with the streamed run's bits."""
    t = random_sparse((60, 40, 30), 2000, seed=3)
    path = str(tmp_path / "t.store")
    write_store_from_coo(t, path, chunk_nnz=256)
    store = TensorStore(path)
    over = {"runtime.streaming": True, "runtime.memory_budget": 40_000}
    plain = _run(store, _cfg(False, "ref", **over))
    traced = _run(store, _cfg(True, "ref", **over))
    assert traced.fits == plain.fits
    records = obs_trace.get_tracer().records()
    by_id = {r["id"]: r for r in records}
    kids = _children(records)
    updates = [r for r in records if r["name"] == "mode_update"]
    assert len(updates) == t.nmodes * SWEEPS
    for r in updates:
        assert kids[r["id"]][-2:] == ["exchange", "solve"]
    for r in records:
        if r["name"] == "exchange":
            assert r["id"] not in kids
        if r["name"] == "solve":
            assert by_id[r["parent"]]["name"] == "mode_update"
