"""The program's registry in the harness's readings: taken before and
after the untraced profiled sweeps, kept although the traced sweeps reset
it, and read by ``walked_slot_share``."""
from __future__ import annotations

import time

import pytest

from chipbench import harness, spec
from repro_torch import obs
from repro_torch.core import als as als_mod

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 91
GAUGE = "ec.walked_slot_share.mode{}"


def _traced_run(root, cell, monkeypatch):
    """A traced run on the CPU, and the readings its readers read."""
    kept = []
    traced = harness._traced

    def keep(*args, **kw):
        kept.append(traced(*args, **kw))
        return kept[-1]

    monkeypatch.setattr(harness, "_traced", keep)
    r = harness.run(cell, SEED, 0.3, True, t_start=time.perf_counter(),
                    root=root, device="cpu", log=lambda msg: None)
    (readings,) = kept
    return r, readings


@pytest.mark.parametrize("cell", CELLS)
def test_the_compile_gauges_outlive_the_tracers_reset(tiny_root, monkeypatch,
                                                      cell):
    r, readings = _traced_run(tiny_root, cell, monkeypatch)
    assert r["correct"]
    names = [GAUGE.format(d) for d in range(len(readings.shape))]
    for snap in (readings.registry_start, readings.registry):
        assert all(0 < snap["gauges"][n] <= 1 for n in names)
        assert any(k.startswith("solver.") for k in snap["sections"])
    # the run reset the registry after its traced sweeps
    assert obs.get_registry().gauge(names[0]) is None
    share = r["metrics"]["walked_slot_share"]
    assert share["unit"] == "%" and 0 < share["value"] <= 100
    assert share["value"] == pytest.approx(
        100 * sum(readings.registry["gauges"][n] for n in names)
        / len(names))


@pytest.mark.parametrize("cell", CELLS)
def test_a_counters_rise_spans_the_untraced_sweeps(tiny_root, monkeypatch,
                                                   cell):
    sweep = als_mod.als_sweep

    def counted(*args, **kw):
        obs.get_registry().inc("tests.sweeps")
        return sweep(*args, **kw)

    monkeypatch.setattr(als_mod, "als_sweep", counted)
    _, readings = _traced_run(tiny_root, cell, monkeypatch)
    start = readings.registry_start["counters"]["tests.sweeps"]
    traffic = spec.load_cell(cell, tiny_root).traffic
    # warm-up, then the window's sweeps, at least one after its first
    assert start >= traffic["warmup_sweeps"] + 2
    assert (readings.registry["counters"]["tests.sweeps"] - start
            == traffic["profiled_sweeps"])


def _readings(gauges):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1, shape=(2, 2),
        rows_used=(2, 2), rank=1, num_devices=1, cards=1, untraced=[],
        traced=[], traced_sweeps=1,
        registry_start={"counters": {}, "gauges": {}},
        registry={"counters": {}, "gauges": gauges})


@pytest.mark.parametrize("gauges", [{}, {GAUGE.format(0): 0.5},
                                    {"ec.other.mode0": 0.5,
                                     "ec.other.mode1": 0.5}])
def test_walked_slot_share_reads_nothing_without_every_modes_gauge(gauges):
    assert spec.metric_reader("walked_slot_share")(_readings(gauges)) is None


def test_walked_slot_share_is_the_unweighted_mean_over_modes():
    r = _readings({GAUGE.format(0): 0.25, GAUGE.format(1): 0.75,
                   GAUGE.format(2): 0.1})
    assert spec.metric_reader("walked_slot_share")(r) == pytest.approx(50.0)
