"""The cell ``reddit-r32.4chip`` at its tests size on the CPU, and the four
readers of the path across cards: ``exchange_ms``, ``exchange_link_share``
and ``ec_card_spread_pct`` (the device trace, with the program's
``comm.sent_bytes`` counters) and ``padded_row_share`` (the program's
partition gauges)."""
from __future__ import annotations

import time

import pytest

from chipbench import harness, link, spec
from chipbench.profile import WINDOW, Event

CELL = "reddit-r32.4chip"
SEED = 2**31 + 4099
DEVICE_READERS = ("exchange_ms", "exchange_link_share", "ec_card_spread_pct")
ROWS = "partition.padded_rows.mode{}"
SENT = "comm.sent_bytes.{}.dev{}"


def _readings(*, traced=(), untraced=(), counters_start=None, counters=None,
              gauges=None, cards=4, num_devices=4, traced_sweeps=2,
              shape=(100, 10, 90)):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1, shape=shape,
        rows_used=shape, rank=1, num_devices=num_devices, cards=cards,
        untraced=list(untraced), traced=list(traced),
        traced_sweeps=traced_sweeps,
        registry_start={"counters": dict(counters_start or {}), "gauges": {}},
        registry={"counters": dict(counters or {}),
                  "gauges": dict(gauges or {})})


def _read(name, r):
    return spec.metric_reader(name)(r)


def _scope(name, t0, t1):
    return Event(name, t0, t1, "user_annotation", None)


def _copy(t0, t1, card, name="Memcpy PtoP (Device -> Device)"):
    return Event(name, t0, t1, "gpu_memcpy", card)


def _kernel(t0, t1, card, name="ec_sorted_kernel"):
    return Event(name, t0, t1, "kernel", card)


def _steps(n):
    return [_scope(WINDOW, 0, 1000 * n)] + [
        _scope(f"step {k}", 1000 * k, 1000 * k + 900) for k in range(n)]


def test_the_cell_runs_on_four_cards_with_the_configurations_cut():
    cell = spec.load_cell(CELL)
    assert cell.entry["chips"] == 4
    assert cell.config["devices"] == [f"cuda:{k}" for k in range(4)]
    assert cell.config["shape"] == [8_211_298, 176_962, 8_116_559]
    assert cell.config["nnz"] == 4_687_474_081
    assert (cell.config["scale"], cell.config["mode_scale"]) == (1e-2, 1.0)
    assert {m["name"] for m in cell.per_layer} >= {
        *DEVICE_READERS, "padded_row_share"}


def test_a_traced_cpu_run_reads_the_padded_rows_and_no_device_trace(
        tiny_root):
    r = harness.run(CELL, SEED, 0.3, True, t_start=time.perf_counter(),
                    root=tiny_root, device="cpu", log=lambda msg: None)
    assert r["correct"]
    share = r["metrics"]["padded_row_share"]
    assert share["unit"] == "%" and share["value"] > 0
    assert not set(DEVICE_READERS) & set(r["metrics"])


def test_exchange_ms_is_the_busiest_cards_work_inside_exchange():
    ev = [_scope(WINDOW, 0, 5000),
          _scope("exchange", 100, 600), _scope("exchange", 2000, 2500),
          _copy(100, 300, 0), _copy(300, 400, 0, "Memcpy DtoD"),
          _copy(2000, 2100, 0),
          _copy(100, 500, 1), _copy(2000, 2300, 1),
          # outside every exchange scope: not counted
          _copy(1000, 1900, 1), _kernel(100, 600, 2, "ec_combine")]
    r = _readings(traced=ev, traced_sweeps=2)
    # card 1: 400 + 300 ns; card 2's kernel: 500 ns
    assert _read("exchange_ms", r) == pytest.approx(700 / 1e6 / 2)


def _at_the_peak(sent_per_sweep, sweeps=2):
    """Two cards whose every traced exchange copies ``sent_per_sweep``
    bytes at NVLink's one-way peak, and counters that rose by that much a
    sweep over ``sweeps`` untraced sweeps."""
    ns = round(sent_per_sweep / link.NVLINK_BYTES_PER_S * 1e9)
    traced = [_scope(WINDOW, 0, 10 * ns)]
    for k in range(2):
        t0 = 4 * k * ns
        traced += [_scope("exchange", t0, t0 + 2 * ns),
                   _copy(t0, t0 + ns, 0), _copy(t0, t0 + ns, 1)]
    start = {SENT.format("gather", 0): 5, SENT.format("gather", 1): 7}
    end = {SENT.format("gather", 0): 5 + sweeps * sent_per_sweep,
           SENT.format("gather", 1): 7 + sweeps * sent_per_sweep // 2}
    return _readings(traced=traced, untraced=_steps(sweeps),
                     counters_start=start, counters=end, traced_sweeps=2)


def test_exchange_link_share_reads_100_at_the_peak_and_no_more():
    # 3.465 GB a sweep, 7.7 ms at 450 GB/s
    r = _at_the_peak(3_465_000_000)
    share = _read("exchange_link_share", r)
    assert share == pytest.approx(100.0, rel=1e-9)
    assert share <= 100.0 + 1e-9


def test_exchange_link_share_counts_every_kind_of_the_busiest_sender():
    sent = 450_000
    r = _at_the_peak(sent)
    r.registry["counters"][SENT.format("merge", 1)] = 2 * sent
    # card 1: sent / 2 a sweep of gather and sent of merge
    assert link.sent_bytes_per_sweep(r) == pytest.approx(1.5 * sent)
    assert _read("exchange_link_share", r) == pytest.approx(150.0, rel=1e-3)


def test_ec_card_spread_pct_sums_the_busiest_over_the_mean_card_per_span():
    ev = [_scope(WINDOW, 0, 5000),
          _scope("ec", 0, 1000), _scope("ec", 2000, 3000),
          _kernel(0, 100, 0), _kernel(0, 50, 1),
          _kernel(2000, 2020, 0), _kernel(2000, 2060, 1),
          _kernel(1200, 1900, 1)]   # outside the spans
    r = _readings(traced=ev, cards=2, num_devices=2)
    assert _read("ec_card_spread_pct", r) == pytest.approx(
        100 * ((100 + 60) / (75 + 40) - 1))


def test_an_even_ec_reads_zero_spread():
    ev = [_scope(WINDOW, 0, 5000), _scope("ec", 0, 1000)] + [
        _kernel(0, 300, c) for c in range(4)]
    assert _read("ec_card_spread_pct", _readings(traced=ev)) == 0


def test_padded_row_share_is_the_padded_rows_over_the_tensors():
    gauges = {ROWS.format(0): 120, ROWS.format(1): 16, ROWS.format(2): 104}
    r = _readings(gauges=gauges, shape=(100, 10, 90))
    assert _read("padded_row_share", r) == pytest.approx(100 * 240 / 200)


def test_every_reader_reads_nothing_on_one_device():
    ev = [_scope(WINDOW, 0, 5000), _scope("exchange", 0, 1000),
          _scope("ec", 2000, 3000), _copy(0, 500, 0), _kernel(2000, 2500, 0)]
    gauges = {ROWS.format(d): 16 for d in range(3)}
    r = _readings(traced=ev, untraced=_steps(2), gauges=gauges, cards=1,
                  num_devices=1, counters={SENT.format("gather", 0): 10})
    for name in (*DEVICE_READERS, "padded_row_share"):
        assert _read(name, r) is None, name


def test_every_reader_reads_nothing_without_the_programs_records():
    ev = [_scope(WINDOW, 0, 5000), _copy(0, 500, 0), _copy(0, 500, 1)]
    r = _readings(traced=ev, untraced=_steps(2), cards=2, num_devices=2)
    for name in (*DEVICE_READERS, "padded_row_share"):
        assert _read(name, r) is None, name
    # the spans alone, without the counters: the time, and no share
    ev += [_scope("exchange", 0, 1000)]
    r = _readings(traced=ev, untraced=_steps(2), cards=2, num_devices=2)
    assert _read("exchange_ms", r) > 0
    assert _read("exchange_link_share", r) is None
