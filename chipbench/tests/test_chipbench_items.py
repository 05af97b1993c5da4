"""``ec_items_placed_share`` in the harness's readings: every EC launch of
the untraced profiled sweeps takes the work items placed with its shard,
and the reader counts the counters' rise alone."""
from __future__ import annotations

import time

import pytest

from chipbench import harness, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 93


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


def _readings(start, counters):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1, shape=(2, 2),
        rows_used=(2, 2), rank=1, num_devices=1, cards=1, untraced=[],
        traced=[], traced_sweeps=1,
        registry_start={"counters": start or {}, "gauges": {}},
        registry={"counters": counters or {}, "gauges": {}})


@pytest.mark.parametrize("cell", CELLS)
def test_every_untraced_launch_takes_its_placed_items(tiny_root, monkeypatch,
                                                      cell):
    r, readings = _traced_run(tiny_root, cell, monkeypatch)
    assert r["correct"]
    start, end = (readings.registry_start["counters"],
                  readings.registry["counters"])
    assert end["ec.items.placed"] > start.get("ec.items.placed", 0)
    assert end.get("ec.items.built", 0) == start.get("ec.items.built", 0)
    share = r["metrics"]["ec_items_placed_share"]
    assert share["unit"] == "%" and share["value"] == 100.0


@pytest.mark.parametrize("start, counters", [
    (None, None), (None, {"tests.sweeps": 4}),
    ({"ec.items.placed": 6, "ec.items.built": 2},
     {"ec.items.placed": 6, "ec.items.built": 2})])
def test_ec_items_placed_share_reads_nothing_where_no_counter_rose(
        start, counters):
    read = spec.metric_reader("ec_items_placed_share")
    assert read(_readings(start, counters)) is None


def test_ec_items_placed_share_counts_the_rise_alone():
    r = _readings({"ec.items.placed": 10, "ec.items.built": 5},
                  {"ec.items.placed": 16, "ec.items.built": 7})
    read = spec.metric_reader("ec_items_placed_share")
    assert read(r) == pytest.approx(75.0)
