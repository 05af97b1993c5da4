"""The cell ``patents-r32.1chip`` at its tests size on the CPU, and the two
readers of the EC's split path: ``split_slot_share`` (the program's
gauges) and ``ec_combine_ms`` (the device trace)."""
from __future__ import annotations

import time

import pytest

from chipbench import check, harness, spec
from chipbench.profile import WINDOW, Event

CELL = "patents-r32.1chip"
SEED = 2**31 + 2027
SHARE = "ec.split_slot_share.mode{}"


def _readings(gauges=None, traced=(), traced_sweeps=2, shape=(46, 9, 9)):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1, shape=shape,
        rows_used=shape, rank=1, num_devices=1, cards=1, untraced=[],
        traced=list(traced), traced_sweeps=traced_sweeps,
        registry_start={"counters": {}, "gauges": {}},
        registry={"counters": {}, "gauges": dict(gauges or {})})


def _read(name, r):
    return spec.metric_reader(name)(r)


def test_the_cell_is_correct_at_its_tests_size_and_the_control_is_not(
        tiny_root):
    cell = spec.load_cell(CELL, tiny_root)
    assert cell.config["distribution"] == "uniform"
    assert cell.config["shape"] == [46, 239_172, 239_172]
    r = harness.run(CELL, SEED, 0.3, False, t_start=time.perf_counter(),
                    root=tiny_root, device="cpu", control=True,
                    log=lambda msg: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 3
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert not check.judge(r["control"], limits)


def test_a_traced_run_reads_the_year_mode_wholly_split(tiny_root):
    """At the tests size the year mode is one tile of 8 rows holding every
    nonzero (a split run), the term modes' tiles a block each: a third."""
    r = harness.run(CELL, SEED, 0.3, True, t_start=time.perf_counter(),
                    root=tiny_root, device="cpu", log=lambda msg: None)
    assert r["correct"]
    share = r["metrics"]["split_slot_share"]
    assert share["unit"] == "%"
    assert share["value"] == pytest.approx(100 / 3)
    # no card: the device trace holds nothing to read
    assert "ec_combine_ms" not in r["metrics"]


def test_split_slot_share_is_the_unweighted_mean_over_modes():
    r = _readings({SHARE.format(0): 1.0, SHARE.format(1): 0.0,
                   SHARE.format(2): 0.25, "ec.partials.mode0": 17_600})
    assert _read("split_slot_share", r) == pytest.approx(125 / 3)


@pytest.mark.parametrize("gauges", [
    {}, {SHARE.format(0): 1.0, SHARE.format(1): 0.0},
    {"ec.walked_slot_share.mode0": 0.5, "ec.walked_slot_share.mode1": 0.5,
     "ec.walked_slot_share.mode2": 0.5}])
def test_split_slot_share_reads_nothing_without_every_modes_gauge(gauges):
    assert _read("split_slot_share", _readings(gauges)) is None


def _scope(name, t0, t1):
    return Event(name, t0, t1, "user_annotation", None)


def _kernel(name, t0, t1, card=0):
    return Event(name, t0, t1, "kernel", card)


def test_ec_combine_ms_is_the_combine_inside_ec_kernel_on_the_busiest_card():
    ev = [_scope(WINDOW, 0, 2000),
          _scope("ec.kernel", 100, 400), _scope("ec.kernel", 1000, 1300),
          _kernel("ec_item_kernel<3, 4, false, SortedMeta>", 110, 300),
          _kernel("ec_combine_kernel(float const*, int const*, float*, "
                  "int, int, int)", 300, 340),
          _kernel("ec_combine_kernel", 1200, 1290),
          # outside every ec.kernel scope: not counted
          _kernel("ec_combine_kernel", 500, 600),
          # another card, less combine time
          _kernel("ec_combine_kernel", 1000, 1100, card=1)]
    r = _readings(traced=ev, traced_sweeps=2)
    assert _read("ec_combine_ms", r) == pytest.approx((40 + 90) / 1e6 / 2)


def test_ec_combine_ms_is_zero_without_a_split_run_and_none_without_a_card():
    scopes = [_scope(WINDOW, 0, 1000), _scope("ec.kernel", 100, 400)]
    work = [_kernel("ec_item_kernel", 110, 300)]
    assert _read("ec_combine_ms", _readings(traced=scopes + work)) == 0
    assert _read("ec_combine_ms", _readings(traced=scopes)) is None
    no_scope = [_scope(WINDOW, 0, 1000), _kernel("ec_combine_kernel", 1, 9)]
    assert _read("ec_combine_ms", _readings(traced=no_scope)) is None
