"""Whole runs on the CPU at the tests' size, past the look for a card:
sound runs come out correct, the TF32 control and each fault a cell can
have come out not correct."""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from chipbench import check, harness, spec
from chipbench.tests.conftest import FOUR, ROOT, make_tiny_root
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


def test_a_configuration_of_a_new_dataset_runs_at_its_own_tests_size(
        tmp_path):
    """A uniform three-mode profile with a mode of 46 rows (the paper's
    Patents, 46 x 239,172 x 239,172), added as a configuration file, a
    cell file and their entries alone: the tests' copy cuts it to the
    size its file states, and it runs correct while the control does not.
    At that size its 46-row mode is one tile of 8 rows, every nonzero in
    one run of work items that write partials."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", src / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = src / "chipbench"
    conf = json.loads((base / "configs" / "amazon-r32.json").read_text())
    del conf["zipf_a"]
    conf.update(name="uniform46-r32", dataset="patents",
                shape=[46, 239_172, 239_172], nnz=3_596_640_708,
                distribution="uniform", scale=1e-2, mode_scale=1.0,
                tests={"scale": 1e-6, "mode_scale": 1e-2})
    (base / "configs" / "uniform46-r32.json").write_text(json.dumps(conf))
    (base / "workloads" / "uniform46-r32.1chip.json").write_text(json.dumps(
        {"why": "uniform draws",
         "limits": dict.fromkeys(check.NAMES, 1e-3)}))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "uniform46-r32", "source": "tests",
        "file": "chipbench/configs/uniform46-r32.json",
        "reduced": ["scale"], "why": "a dataset the tests have not seen"})
    bench["workloads"].append({
        "name": "uniform46-r32.1chip", "config": "uniform46-r32",
        "traffic": "sweep_fit_each", "chips": 1, "why": "uniform draws"})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.problems(bench, src) == []
    before = _repo_files()

    tiny = tmp_path / "tiny"
    tiny.mkdir()
    make_tiny_root(tiny, src)
    cell = spec.load_cell("uniform46-r32.1chip", tiny)
    assert (cell.config["scale"], cell.config["mode_scale"]) == (1e-6, 1e-2)
    r = _run(tiny, "uniform46-r32.1chip", control=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 3
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert not check.judge(r["control"], limits)
    assert _repo_files() == before


def _repo_files() -> dict:
    paths = [ROOT / "BENCHMARK.json", *(ROOT / "chipbench").rglob("*")]
    return {p: p.read_bytes() for p in paths
            if p.is_file() and "__pycache__" not in p.parts}


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
