"""The readers of the port's spans (``chipbench/spans.py`` and the metrics
that use it) on hand-built profiler events."""
from __future__ import annotations

import pytest

from chipbench import harness, profile, spans, spec
from chipbench.profile import Event

NEW = ("ec_kernel_ms", "ec_prep_ms", "solve_ms", "solve_idle_ms",
       "launches_per_sweep", "syncs_per_sweep")


def _scope(name, t0, t1):
    return Event(name, t0, t1, "user_annotation", None)


def _work(t0, t1, card=0, name="k"):
    return Event(name, t0, t1, "kernel", card)


def _call(name, t):
    return Event(name, t, t + 1, "cuda_runtime", None)


def _readings(untraced=(), traced=(), traced_sweeps=2):
    return harness.Readings(
        plan_s=1.0, compile_s=1.0, placed_bytes=1, nnz=1, shape=(2, 2),
        rows_used=(2, 2), rank=1, num_devices=1, cards=1,
        untraced=list(untraced), traced=list(traced),
        traced_sweeps=traced_sweeps, registry_start={}, registry={})


def _read(name, r):
    return spec.metric_reader(name)(r)


def _window(t1=1000):
    return [_scope(profile.WINDOW, 0, t1)]


def test_ec_kernel_is_its_scope_less_its_items_and_prep_the_rest():
    ev = _window() + [
        _scope("ec", 10, 500), _scope("ec.args", 20, 90),
        _scope("ec.kernel", 100, 400), _scope("ec.items", 120, 180),
        _scope("ec.mask", 400, 450),
        _work(30, 80), _work(130, 170), _work(200, 380), _work(410, 420),
        _work(200, 250, card=1),
    ]
    r = _readings(traced=ev, traced_sweeps=2)
    # card 0: kernel scope 40 + 180 of work, 40 of it in ec.items
    assert spans.busiest_self_ns(ev, "ec.kernel", ("ec.items",)) == 180
    assert _read("ec_kernel_ms", r) == pytest.approx(180 / 1e6 / 2)
    # card 0: ec.args 50, ec.items 40, ec.mask 10
    assert _read("ec_prep_ms", r) == pytest.approx(100 / 1e6 / 2)
    assert _read("ec_ms", r) == pytest.approx(280 / 1e6 / 2)


def test_solve_host_time_and_idle_card_inside_solve_scopes():
    traced = _window() + [_scope("solve", 100, 300), _scope("solve", 600,
                                                             650),
                          _work(100, 290)]
    assert _read("solve_ms", _readings(traced=traced)) == \
        pytest.approx(250 / 1e6 / 2)
    # card 0 has two gaps inside the first solve (150-200, 250-290) and
    # none inside the second; card 1 runs nothing inside either
    untraced = _window() + [
        _scope("sweep", 0, 500), _scope("sweep", 500, 1000),
        _scope("solve", 100, 300), _scope("solve", 600, 800),
        _work(100, 150), _work(200, 250), _work(290, 300), _work(600, 800),
        _work(0, 50, card=1),
    ]
    assert spans.idle_ns_per_card(untraced, "solve") == [90, 400]
    assert _read("solve_idle_ms", _readings(untraced=untraced)) == \
        pytest.approx((90 + 400) / 2 / 1e6 / 2)


def test_runtime_calls_inside_sweep_scopes_over_their_number():
    ev = _window() + [
        _scope("step 0", 0, 450), _scope("sweep", 0, 400),
        _scope("step 1", 450, 1000), _scope("sweep", 500, 900),
        _work(10, 20),
        _call("cudaLaunchKernel", 10), _call("cudaLaunchKernel", 20),
        _call("cudaMemcpyAsync", 30), _call("cudaStreamSynchronize", 40),
        _call("cudaLaunchKernel", 600), _call("cudaMemcpy", 610),
        _call("cudaStreamSynchronize", 620),
        # outside every sweep scope: the fit's read after the sweep
        _call("cudaLaunchKernel", 420), _call("cudaStreamSynchronize", 930),
        # not counted by either
        _call("cudaStreamWaitEvent", 50), _call("cudaEventRecord", 60),
    ]
    r = _readings(untraced=ev)
    assert _read("launches_per_sweep", r) == 4 / 2
    assert _read("syncs_per_sweep", r) == 3 / 2


@pytest.mark.parametrize("name", NEW)
def test_readers_report_nothing_without_a_card(name):
    """No device work (the CPU), or a window without the port's scopes (a
    program without these spans): ``None``, never 0."""
    scopes = [_scope(n, 10 * k, 10 * k + 5) for k, n in enumerate(
        ("sweep", "ec.kernel", "ec.items", "ec.args", "ec.mask", "solve"))]
    calls = [_call("cudaLaunchKernel", 11), _call("cudaStreamSynchronize",
                                                  12)]
    no_card = _window() + scopes + calls
    assert _read(name, _readings(untraced=no_card, traced=no_card)) is None
    no_scope = _window() + [_work(0, 100), _scope("step 0", 0, 200)] + calls
    assert _read(name, _readings(untraced=no_scope, traced=no_scope)) is None
