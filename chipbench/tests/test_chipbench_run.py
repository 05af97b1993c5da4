"""Whole runs on the CPU at the tests' size, past the look for a card:
sound runs come out correct, the TF32 control and each fault a cell can
have come out not correct."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from chipbench import check, harness, spec
from chipbench.tests.conftest import FOUR
from repro_torch import comm
from repro_torch.core import als as als_mod
from repro_torch.kernels import ops as kops

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 77


def _run(root, cell, trace=False, control=False):
    return harness.run(cell, SEED, 0.3, trace, t_start=time.perf_counter(),
                       root=root, device="cpu", control=control,
                       log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(tiny_root, cell):
    r = _run(tiny_root, cell, control=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 3
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in
                                 spec.load_cell(cell).end_to_end}
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert set(limits) == set(check.NAMES)
    assert not check.judge(r["control"], limits)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny_root, cell):
    r = _run(tiny_root, cell, trace=True)
    assert r["correct"]
    got = r["metrics"]
    # the CPU has no device trace: the host's readers report, the
    # device's find nothing to read
    assert {"plan_s", "compile_s", "placed_bytes_per_nnz",
            "als_tail_ms"} <= set(got)
    assert not {"ec_ms", "ec_roofline", "device_idle_pct"} & set(got)
    assert all(v["value"] > 0 for v in got.values())


def _unchanged(plan, mesh, dev, state, updates=None, **kw):
    fit = state.fits[-1] if state.fits else torch.zeros(())
    return dataclasses.replace(state, sweep=state.sweep + 1,
                               fits=state.fits + [fit])


def _half_the_nonzeros(orig):
    def local(indices, values, *args, **kw):
        v = values.clone()
        v[1::2] = 0
        return orig(indices, 2 * v, *args, **kw)
    return local


def _no_exchange(orig):
    def gather(xs, mesh, axis_names, **kw):
        full = orig(xs, mesh, axis_names, **kw)
        n = xs[0].shape[0]
        out = []
        for k, f in enumerate(full):
            g = torch.zeros_like(f)
            g[k * n:(k + 1) * n] = f[k * n:(k + 1) * n]
            out.append(g)
        return out
    return gather


def _altered(orig):
    def solve(m, f_old, grams, mode):
        f, g, lam = orig(m, f_old, grams, mode)
        f[0, 0] += 0.05 * f.abs().max()
        return f, g, lam
    return solve


def _stale_grams(orig):
    """From the second sweep of the window on, each solve hands back the
    gram its factor had before: a cache gone stale after the sweep that
    the reference recomputes."""
    calls = [0]

    def solve(m, f_old, grams, mode):
        calls[0] += 1
        stale = grams[mode].clone()
        f, g, lam = orig(m, f_old, grams, mode)
        late = calls[0] > (WARMUP + 1) * len(grams)
        return f, (stale if late else g), lam
    return solve


WARMUP = spec.load_cell(CELLS[0]).traffic["warmup_sweeps"]
FAULTS = {
    "state unchanged": (als_mod, "als_sweep", lambda o: _unchanged),
    "half the nonzeros": (kops, "mttkrp_local", _half_the_nonzeros),
    "answer altered": (als_mod, "_solve", _altered),
    "grams stale after the first sweep": (als_mod, "_solve", _stale_grams),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, monkeypatch,
                                                  cell, fault):
    mod, name, make = FAULTS[fault]
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    assert not _run(tiny_root, cell)["correct"]


def test_four_devices_are_correct_and_the_exchange_left_out_is_not(
        tiny_root, monkeypatch):
    assert _run(tiny_root, FOUR)["correct"]
    monkeypatch.setattr(comm, "all_gather_axes",
                        _no_exchange(comm.all_gather_axes))
    assert not _run(tiny_root, FOUR)["correct"]


def test_the_command_fails_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(spec.ROOT / "chipbench" / "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_forbidden_modules_are_named_by_their_top_level(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]
    assert json.dumps(harness.FORBIDDEN)
