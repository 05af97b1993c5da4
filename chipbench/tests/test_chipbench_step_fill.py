"""``ec_step_fill_share`` in the harness's readings: the gauges
``api.compile`` sets, read after the untraced profiled sweeps, and the
reader's mean over modes."""
from __future__ import annotations

import time

import pytest

from chipbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 97
GAUGE = "ec.step_fill_share.mode{}"


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


def _readings(gauges, nmodes=2):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1,
        shape=(2,) * nmodes, rows_used=(2,) * nmodes, rank=1, num_devices=1,
        cards=1, untraced=[], traced=[], traced_sweeps=1,
        registry_start={"counters": {}, "gauges": {}},
        registry={"counters": {}, "gauges": gauges})


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reads_the_step_fill_of_every_mode(tiny_root,
                                                      monkeypatch, cell):
    r, readings = _traced_run(tiny_root, cell, monkeypatch)
    assert r["correct"]
    names = [GAUGE.format(d) for d in range(len(readings.shape))]
    gauges = readings.registry["gauges"]
    assert all(0 < gauges[n] <= 1 for n in names)
    share = r["metrics"]["ec_step_fill_share"]
    assert share["unit"] == "%" and 0 < share["value"] <= 100
    assert share["value"] == pytest.approx(
        100 * sum(gauges[n] for n in names) / len(names))


@pytest.mark.parametrize("gauges", [
    {}, {"ec.walked_slot_share.mode0": 0.5,
         "ec.walked_slot_share.mode1": 0.5},
    {GAUGE.format(0): 0.9}])
def test_ec_step_fill_share_reads_nothing_where_a_mode_lacks_its_gauge(
        gauges):
    read = spec.metric_reader("ec_step_fill_share")
    assert read(_readings(gauges)) is None


def test_ec_step_fill_share_is_the_unweighted_mean_over_modes():
    read = spec.metric_reader("ec_step_fill_share")
    r = _readings({GAUGE.format(0): 1.0, GAUGE.format(1): 0.5,
                   GAUGE.format(2): 0.75}, nmodes=3)
    assert read(r) == pytest.approx(75.0)
