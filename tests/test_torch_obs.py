"""The port's observability layer (``repro_torch.obs``) on the CPU.

Twins of tests/test_obs.py: the shared clock (and its use by the port's
threaded modules), the span tracer (shared no-op while disabled, nesting,
thread-local stacks), Chrome-trace export and validation, the CLI, the
metrics registry and histogram, the event log and its sink, StreamMonitor
and the streamer's events, overlap_report's steady fractions, and a traced
solver run whose spans nest run → sweep → mode_update → {ec, exchange} at
≥ 95 % coverage with fits and factors bitwise those of the untraced run —
also for every EC variant on a tile whose run is longer than
``CHUNK_BLOCKS`` blocks, and for a streamed run. Held against the
reference: on every span name the reference records, the port's counts
equal the reference's traced run's on the same tensor (the port records
more stages besides), and a trace exported by either package passes the
other's validator.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api.solver import CPSolver  # noqa: E402
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
from repro_torch.core.mttkrp import Placed, cp_mesh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import clock  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.export import (chrome_trace, dump_chrome_trace,  # noqa: E402
                                    span_counts, validate_trace)
from repro_torch.obs.metrics import (EventLog, LogHistogram,  # noqa: E402
                                     MetricsRegistry)
from repro_torch.obs.profiler import StreamMonitor, annotation  # noqa: E402
from repro_torch.store import write_store_from_coo  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts from disabled tracers and clean global registries
    (both packages'), and leaks no enabled tracer into other files."""
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


# -- clock -------------------------------------------------------------------

def test_clock_monotonic_and_wall():
    ts = [clock.now() for _ in range(100)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert abs(clock.walltime() - time.time()) < 5.0


def test_threaded_runtime_modules_share_the_obs_clock():
    from repro_torch.core import baselines
    from repro_torch.schedule import rebalance
    from repro_torch.sparse import stream
    from repro_torch.training import checkpoint
    for mod in (stream, rebalance, checkpoint, baselines):
        assert mod.clock is clock, mod.__name__


# -- tracer ------------------------------------------------------------------

def test_disabled_span_is_shared_noop():
    """Tracing off, every span is the one shared no-op object: the
    untraced hot path allocates and records nothing."""
    tracer = obs_trace.get_tracer()
    assert not tracer.enabled
    s1 = tracer.span("a", mode=1)
    s2 = tracer.span("b", annotate=True)
    assert s1 is s2
    assert obs_trace.span("ec", mode=0) is obs_trace.span("exchange")
    with s1:
        pass
    assert tracer.records() == []


def test_span_nesting_and_attrs():
    obs_trace.enable()
    with obs_trace.span("outer", sweep=1):
        with obs_trace.span("inner", mode=2):
            pass
        with obs_trace.span("inner", mode=3):
            pass
    recs = {}
    for r in obs_trace.get_tracer().records():
        recs.setdefault(r["name"], []).append(r)
    outer, = recs["outer"]
    assert outer["parent"] is None and outer["attrs"] == {"sweep": 1}
    inner = recs["inner"]
    assert [r["parent"] for r in inner] == [outer["id"], outer["id"]]
    assert [r["attrs"]["mode"] for r in inner] == [2, 3]
    for r in inner:
        assert outer["t0"] <= r["t0"] <= r["t1"] <= outer["t1"]
    summary = obs_trace.get_tracer().summary()
    assert summary["inner"]["count"] == 2
    assert summary["outer"]["count"] == 1


def test_span_stacks_are_thread_local():
    obs_trace.enable()
    started = threading.Event()
    release = threading.Event()

    def worker():
        with obs_trace.span("worker_root"):
            started.set()
            release.wait(5)

    t = threading.Thread(target=worker, name="obs-worker")
    with obs_trace.span("main_root"):
        t.start()
        started.wait(5)
        release.set()
        t.join(10)
    assert not t.is_alive()
    recs = {r["name"]: r for r in obs_trace.get_tracer().records()}
    assert recs["worker_root"]["parent"] is None
    assert recs["worker_root"]["tid"] != recs["main_root"]["tid"]
    assert recs["worker_root"]["thread"] == "obs-worker"


def test_annotation_is_a_record_function_scope_on_the_cpu():
    """``annotate=True`` enters ``torch.profiler.record_function`` (no
    NVTX on a CPU-only torch, and nothing raises): a CPU profile sees the
    span's name."""
    obs_trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs_trace.span("traced_stage", annotate=True):
            torch.ones(8).sum()
        with annotation("bare_annotation"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"traced_stage", "bare_annotation"} <= names
    assert [r["name"] for r in obs_trace.get_tracer().records()] == \
        ["traced_stage"]


# -- export + validation -----------------------------------------------------

def _demo_records():
    obs_trace.enable()
    with obs_trace.span("run"):
        for k in range(2):
            with obs_trace.span("sweep", sweep=k):
                with obs_trace.span("ec"):
                    pass
    return obs_trace.get_tracer().records()


def test_chrome_trace_pairs_and_nests():
    records = _demo_records()
    trace = chrome_trace(records, pid=1)
    evs = [e for e in trace["traceEvents"] if e["ph"] in "BE"]
    assert [(e["ph"], e["name"]) for e in evs] == [
        ("B", "run"), ("B", "sweep"), ("B", "ec"), ("E", "ec"),
        ("E", "sweep"), ("B", "sweep"), ("B", "ec"), ("E", "ec"),
        ("E", "sweep"), ("E", "run")]
    assert evs[1]["args"] == {"sweep": 0}
    meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == 1 and meta[0]["name"] == "thread_name"
    assert span_counts(records) == {"run": 1, "sweep": 2, "ec": 2}


def test_validate_trace_accepts_good_rejects_broken():
    good = chrome_trace(_demo_records(), pid=1)
    res = validate_trace(good)
    assert res["ok"] and res["coverage"] > 0.99, res

    broken = {"traceEvents": good["traceEvents"][:-2]}
    res = validate_trace(broken)
    assert not res["ok"]
    assert any("never closed" in p for p in res["problems"])

    tids = {"pid": 1, "tid": 7}
    res = validate_trace({"traceEvents": [
        {"name": "p", "ph": "B", "ts": 0.0, **tids},
        {"name": "a", "ph": "B", "ts": 1.0, **tids},
        {"name": "a", "ph": "E", "ts": 50.0, **tids},
        {"name": "b", "ph": "B", "ts": 10.0, **tids},
        {"name": "b", "ph": "E", "ts": 60.0, **tids},
        {"name": "p", "ph": "E", "ts": 100.0, **tids},
    ]})
    assert not res["ok"]
    assert any("overlaps the previous sibling" in p for p in res["problems"])

    res = validate_trace({"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0.0, **tids},
        {"name": "a", "ph": "E", "ts": 10.0, **tids},
        {"name": "b", "ph": "B", "ts": 90.0, **tids},
        {"name": "b", "ph": "E", "ts": 100.0, **tids},
    ]}, min_coverage=0.95)
    assert not res["ok"] and res["coverage"] < 0.25
    assert any("coverage" in p for p in res["problems"])


def test_validator_cli_expectations(tmp_path):
    from repro_torch.obs.__main__ import main
    path = str(tmp_path / "t.json")
    dump_chrome_trace(path, _demo_records())
    assert main([path, "--expect-span", "sweep=2",
                 "--expect-span", "ec"]) == 0
    assert main([path, "--expect-span", "sweep=3"]) == 1
    assert main([path, "--expect-span", "exchange"]) == 1


# -- metrics registry --------------------------------------------------------

def test_registry_counters_gauges_latency():
    reg = MetricsRegistry()
    reg.inc("q"), reg.inc("q", 4)
    reg.set_gauge("depth", 3)
    reg.observe("op", 0.01)
    with reg.time("op"):
        pass
    assert reg.counter("q") == 5
    assert reg.counter("absent") == 0
    assert reg.gauge("depth") == 3
    lat = reg.latency("op")
    assert lat["count"] == 2 and lat["p50_ms"] is not None
    assert reg.latency("absent") is None
    snap = reg.snapshot()
    assert snap["counters"] == {"q": 5} and snap["gauges"] == {"depth": 3}


def test_registry_providers_and_reentrancy():
    reg = MetricsRegistry()

    def section():
        reg.inc("report_calls")  # reentrant mutation
        return {"ok": True}

    reg.register_provider("demo", section)
    rep = reg.report()
    assert rep["sections"] == {"demo": {"ok": True}}
    assert rep["uptime_s"] >= 0
    assert reg.counter("report_calls") == 1
    reg.unregister_provider("demo")
    assert reg.report()["sections"] == {}
    reg.unregister_provider("demo")  # idempotent


def test_log_histogram_percentile_geometry():
    h = LogHistogram()
    for _ in range(99):
        h.record(1e-3)
    h.record(1.0)
    assert h.count == 100
    assert 1e-3 <= h.percentile(0.5) <= 1.3e-3
    assert 1.0 <= h.percentile(0.995) <= 1.3
    assert LogHistogram().percentile(0.5) is None
    with pytest.raises(ValueError):
        LogHistogram(lo=1.0, hi=0.1)


def test_log_histogram_snapshot_never_torn():
    h = LogHistogram()
    stop = threading.Event()
    value = 1e-3

    def hammer():
        while not stop.is_set():
            h.record(value)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            s = h.snapshot()
            if s["count"] == 0:
                continue
            assert s["mean_ms"] == pytest.approx(value * 1e3, rel=1e-9), s
            assert s["total_s"] == pytest.approx(s["count"] * value,
                                                 rel=1e-9), s
            assert 1e-3 <= s["p50_ms"] / 1e3 <= 1.3e-3, s
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)


# -- event log ---------------------------------------------------------------

def test_event_log_stamps_payloads_and_sink(tmp_path):
    log = EventLog()
    log.emit("sweep", sweep=1)
    log.emit("rebalance", sweep=1, migrations=0)
    log.emit("sweep", sweep=2)
    assert len(log) == 3
    for e in log.events():
        assert e["t"] > 0 and e["wall"] > 0 and "kind" in e
    assert log.payloads("sweep") == [{"sweep": 1}, {"sweep": 2}]
    assert log.payloads("rebalance") == [{"sweep": 1, "migrations": 0}]
    path = str(tmp_path / "events.jsonl")
    log.set_sink(path)
    log.emit("sweep", sweep=3)
    log.close_sink()
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert [e["kind"] for e in lines] == ["sweep", "rebalance", "sweep",
                                         "sweep"]
    assert lines[-1]["sweep"] == 3
    log.emit("sweep", sweep=4)  # post-close emission: memory only
    assert len(open(path).read().splitlines()) == 4


# -- stream monitor + overlap_report fractions -------------------------------

def test_stream_monitor_window_attribution():
    log = EventLog()
    log.emit("h2d_build", build_s=0.1, bytes=10, mode=0, shard=0)
    log.emit("h2d_wait", wait_s=0.1, cold=True, mode=0, shard=0)
    log.emit("h2d_build", build_s=0.1, bytes=10, mode=0, shard=1)
    log.emit("h2d_wait", wait_s=0.001, cold=False, mode=0, shard=1)
    log.emit("h2d_wait", wait_s=0.005, cold=False, mode=1, shard=0)
    rep = StreamMonitor(log).report()
    assert rep["num_windows"] == 3
    a, b, c = rep["windows"]
    assert a["exposed_s"] == pytest.approx(0.1)
    assert a["hidden_s"] == pytest.approx(0.0)
    assert b["hidden_s"] == pytest.approx(0.099)
    assert c["transfer_s"] == 0.0
    assert rep["stalled_windows"] == 1
    assert rep["transfer_s"] == pytest.approx(0.2)
    assert rep["exposed_s"] == pytest.approx(0.101)


def _sleep_streamer(build_s, events=None):
    """Minimal _StreamerBase subclass: every build sleeps a fixed time."""
    from repro_torch.sparse.stream import _StreamerBase

    class _SleepStreamer(_StreamerBase):
        def _build(self, key):
            time.sleep(build_s)
            return Placed([], [])

        def _key_nbytes(self, key):
            return 8

    return _SleepStreamer(cp_mesh(1, 1, devices=["cpu"]), prefetch=2,
                          events=events)


def test_streamer_exposed_vs_hidden_under_slow_and_fast_transfers():
    log = EventLog()
    slow = _sleep_streamer(0.05, events=log)
    try:
        slow._wait("w0")  # cold: the consumer blocks for the whole build
        st = slow.stats_snapshot()
        assert st["cold_builds"] == 1
        assert st["exposed_s"] >= 0.9 * st["transfer_s"] > 0
    finally:
        slow.close()
    assert [e["kind"] for e in log.events()] == ["h2d_build", "h2d_wait"]
    assert log.events("h2d_wait")[0]["cold"] is True

    fast = _sleep_streamer(0.05)
    try:
        fast._dispatch("w0")
        time.sleep(0.25)  # "compute" long enough to hide the transfer
        fast._wait("w0")
        st = fast.stats_snapshot()
        assert st["cold_builds"] == 0
        assert st["transfer_s"] >= 0.05
        assert st["exposed_s"] <= 0.5 * st["transfer_s"]
    finally:
        fast.close()


class _FakeStreamSolver:
    """Just enough of CPSolver for overlap_report: injected aggregate
    stats + per-sweep stream_sweep events."""

    streaming = True
    stream_events = CPSolver.stream_events  # the real stamped-view property

    def __init__(self, sweeps, budget=1 << 20):
        from types import SimpleNamespace
        self.events = EventLog()
        total_t = total_e = 0.0
        for i, (transfer, exposed) in enumerate(sweeps):
            total_t += transfer
            total_e += exposed
            self.events.emit("stream_sweep", sweep=i + 1,
                             transfer_s=transfer, exposed_s=exposed,
                             hidden_s=max(transfer - exposed, 0.0),
                             overlap_fraction=(
                                 (transfer - exposed) / transfer
                                 if transfer > 0 else None),
                             shards_streamed=4, bytes_streamed=1000)
        snap = {"transfer_s": total_t, "exposed_s": total_e,
                "peak_resident_bytes": budget // 2, "bytes_streamed": 1000,
                "builds": 4 * len(sweeps), "cold_builds": 4,
                "spill_hits": 0, "spill_saves": 0}
        self.streamer = SimpleNamespace(stats_snapshot=lambda: dict(snap))
        self.config = SimpleNamespace(runtime=SimpleNamespace(
            memory_budget=budget, stream_buffers=2))
        self.stream_plans = [SimpleNamespace(num_shards=4, shard_bytes=100)]

    overlap_report = CPSolver.overlap_report


def test_overlap_report_steady_state_fractions():
    fast = _FakeStreamSolver([(1.0, 1.0), (1.0, 0.0), (1.0, 0.0)])
    rep = fast.overlap_report()
    assert rep["enabled"]
    assert rep["overlap_fraction_steady"] == pytest.approx(1.0)
    assert rep["overlap_fraction"] == pytest.approx(2.0 / 3.0)
    assert [e["exposed_s"] for e in rep["per_sweep"]] == [1.0, 0.0, 0.0]

    slow = _FakeStreamSolver([(1.0, 1.0), (1.0, 1.0), (1.0, 1.0)])
    rep = slow.overlap_report()
    assert rep["overlap_fraction_steady"] == pytest.approx(0.0)
    assert rep["overlap_fraction"] == pytest.approx(0.0)

    mixed = _FakeStreamSolver([(2.0, 2.0), (1.0, 0.25), (1.0, 0.25)])
    assert mixed.overlap_report()["overlap_fraction_steady"] == \
        pytest.approx(0.75)
    first = _FakeStreamSolver([(1.0, 0.5)])
    assert first.overlap_report()["overlap_fraction_steady"] is None


# -- traced solver runs ------------------------------------------------------

def _cfg(trace, **over):
    return api.preset("paper", {"rank": 4, "runtime.num_devices": 1,
                                "runtime.tol": 0.0, "runtime.seed": 0,
                                "runtime.trace": trace, **over})


def _port_tensor(t):
    return SparseTensor(t.indices, t.values, t.shape)


def _run(t, cfg, sweeps=2):
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        res = s.run(sweeps)
    return res


def test_traced_run_nests_and_matches_untraced(small_tensor, tmp_path):
    """A traced run's Chrome trace nests run → sweep → mode_update → {ec,
    exchange} at ≥ 95 % top-level coverage, its fits and factors are
    bitwise the untraced run's, and close() deregisters its section from
    the process-wide report."""
    t = _port_tensor(small_tensor)
    r_plain = _run(t, _cfg(False))
    cfg = _cfg(True)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        assert obs_trace.get_tracer().enabled
        r_traced = s.run(2)
        path = str(tmp_path / "trace.json")
        trace = s.dump_trace(path)
        rep = s.report()
        assert s._obs_name in obs.report()["sections"]
    assert s._obs_name not in obs.report()["sections"]

    assert r_traced.fits == r_plain.fits
    for a, b in zip(r_plain.factors, r_traced.factors):
        np.testing.assert_array_equal(a, b)

    res = validate_trace(trace, min_coverage=0.95)
    assert res["ok"], res["problems"]
    nmodes = t.nmodes
    assert res["span_counts"]["run"] == 1
    assert res["span_counts"]["sweep"] == 2
    for name in ("mode_update", "ec", "exchange"):
        assert res["span_counts"][name] == 2 * nmodes, name
    assert json.load(open(path)) == trace

    by_id = {r["id"]: r for r in obs_trace.get_tracer().records()}
    parent_names = {"ec": "mode_update", "exchange": "mode_update",
                    "mode_update": "sweep", "sweep": "run"}
    for r in by_id.values():
        want = parent_names.get(r["name"])
        if want is not None:
            assert by_id[r["parent"]]["name"] == want, r

    assert rep["sections"]["overlap"] == {"enabled": False}
    assert rep["sections"]["exchange"] == s.exchange_report(measure=False)
    assert "counted" not in rep["sections"]["exchange"]
    assert rep["sections"]["imbalance"] == s.imbalance_report()


def _hot_row_tensor(seed=4):
    """One hot output row of mode 1 (640 nonzeros, 40 blocks of 16) among
    light ones (tests/_torch_cases.py's hot-row case): with tile 8 and
    block_p 16 its tile's run is longer than CHUNK_BLOCKS."""
    rng = np.random.default_rng(seed)
    shape = (20, 12, 10)
    ind = np.stack([rng.integers(0, s, 730) for s in shape], axis=1)
    ind[:640, 1] = 2
    return SparseTensor(ind.astype(np.int32),
                        rng.normal(size=730).astype(np.float32), shape)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked", "ref"])
def test_traced_sweep_bitwise_on_runs_longer_than_chunk_blocks(variant):
    """The traced sweep (each stage's span ending in a synchronise) gives
    the untraced sweep's bits also where a tile's run is cut into several
    work items (the two-level order of the kernels' plain versions)."""
    from _torch_cases import longest_run
    t = _hot_row_tensor()
    over = {"kernel.variant": variant, "kernel.autotune": False,
            "partition.tile": 8, "partition.block_p": 16,
            "partition.layout": "sorted" if variant == "sorted"
            else "blocked"}
    plan = api.plan(t, _cfg(False, **over), device="cpu")
    assert longest_run(plan.modes[1].block_to_tile[0]) > \
        _build.CHUNK_BLOCKS
    plain = _run(t, _cfg(False, **over), sweeps=3)
    traced = _run(t, _cfg(True, **over), sweeps=3)
    assert traced.fits == plain.fits
    for a, b in zip(plain.factors, traced.factors):
        np.testing.assert_array_equal(a, b)
    assert span_counts(obs_trace.get_tracer().records())["ec"] == 9


def test_traced_streaming_run_spans_and_events(tmp_path):
    """A traced streamed run opens h2d_window and ec spans per window
    (under mode_update), keeps the untraced streamed run's bits, and its
    streamer events feed StreamMonitor with one record per window build."""
    t = random_sparse((60, 40, 30), 2000, seed=3)
    path = str(tmp_path / "t.store")
    write_store_from_coo(t, path, chunk_nnz=256)
    from repro_torch.store import TensorStore
    store = TensorStore(path)
    over = {"runtime.streaming": True, "runtime.memory_budget": 40_000}
    plain = _run(store, _cfg(False, **over))
    cfg = _cfg(True, **over)
    with api.compile(api.plan(store, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        traced = s.run(2)
        shards = [sp.num_shards for sp in s.stream_plans]
        windows = s.stream_monitor().report()
        builds = len(s.events.events("h2d_build"))
        stream_events = s.stream_events
    assert traced.fits == plain.fits
    for a, b in zip(plain.factors, traced.factors):
        np.testing.assert_array_equal(a, b)
    assert min(shards) >= 2, shards
    counts = span_counts(obs_trace.get_tracer().records())
    assert counts["h2d_window"] == counts["ec"] == 2 * sum(shards)
    assert counts["super_shard_split"] == 3
    # every window of both sweeps, and the prefetch of the next sweep's
    # first window that the last get dispatched
    assert windows["num_windows"] == builds >= 2 * sum(shards)
    assert [e["sweep"] for e in stream_events] == [1, 2]
    assert sum(e["shards_streamed"] for e in stream_events) == builds


def test_port_span_counts_equal_the_reference(small_tensor):
    """The reference's traced run and the port's, on the same tensor and
    config, record each span the reference records as often; the port
    records its finer stages (shards, solve, eigh, fit, ec.*) besides."""
    jcfg = japi.preset("paper", {"rank": 4, "runtime.num_devices": 1,
                                 "runtime.tol": 0.0, "runtime.trace": True})
    with japi.compile(japi.plan(small_tensor, jcfg), jcfg) as s:
        j_fits = s.run(2).fits
    j_counts = jexport.span_counts(jobs.trace.get_tracer().records())
    t_fits = _run(_port_tensor(small_tensor), _cfg(True)).fits
    t_counts = span_counts(obs_trace.get_tracer().records())
    assert {n: t_counts.get(n) for n in j_counts} == j_counts
    np.testing.assert_allclose(t_fits, j_fits, atol=1e-4)


def test_traces_cross_validate_between_the_packages(small_tensor):
    """A trace exported by either package passes the other's
    validator."""
    _run(_port_tensor(small_tensor), _cfg(True))
    t_trace = chrome_trace(obs_trace.get_tracer().records())
    jcfg = japi.preset("paper", {"rank": 4, "runtime.num_devices": 1,
                                 "runtime.tol": 0.0, "runtime.trace": True})
    with japi.compile(japi.plan(small_tensor, jcfg), jcfg) as s:
        s.run(2)
    j_trace = jexport.chrome_trace(jobs.trace.get_tracer().records())
    for validate in (validate_trace, jexport.validate_trace):
        for trace in (t_trace, j_trace):
            res = validate(trace, min_coverage=0.95)
            assert res["ok"], res["problems"]
    j_counts = validate_trace(j_trace)["span_counts"]
    t_counts = jexport.validate_trace(t_trace)["span_counts"]
    assert {n: t_counts.get(n) for n in j_counts} == j_counts


def test_solver_events_and_dumps(small_tensor, tmp_path):
    cfg = _cfg(False)
    t = _port_tensor(small_tensor)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        s.run(2)
        assert [e["sweep"] for e in s.events.payloads("sweep")] == [1, 2]
        assert s.stream_events == []  # resident run: no stream_sweep events
        assert s.schedule_events == []
        path = str(tmp_path / "events.jsonl")
        s.dump_events(path)
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert [e["kind"] for e in lines].count("sweep") == 2
    # the compile placed every mode once: one build and one wait each
    assert [e["kind"] for e in lines].count("h2d_build") == t.nmodes
    assert obs_trace.get_tracer().records() == []


def test_launcher_trace_and_events(tmp_path, capsys):
    """--trace-out writes a trace that ``python -m repro_torch.obs``
    accepts, and --events-out mirrors the events as JSON lines."""
    from repro_torch.launch import decompose as launcher
    from repro_torch.obs.__main__ import main as validate_main
    trace, events = str(tmp_path / "t.json"), str(tmp_path / "e.jsonl")
    launcher.main(["--preset", "paper", "--profile", "twitch", "--scale",
                   "2e-5", "--iters", "2", "--device", "cpu",
                   "--trace-out", trace, "--events-out", events])
    out = capsys.readouterr().out
    assert f"trace: {trace} [" in out and "sweep=2" in out
    n = len(open(events).read().splitlines())
    assert f"events: {events} ({n} lines)" in out
    assert validate_main([trace, "--expect-span", "sweep=2",
                          "--expect-span", "run=1"]) == 0
