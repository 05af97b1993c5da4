"""BENCHMARK.json and the files it names: every configuration, cell,
traffic mix and metric found by name, and the benchmark's own rules."""
from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import pytest

from chipbench import check, spec

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_benchmark_keys_and_rules():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["chipbench"]
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert spec.problems(BENCH) == []
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}


def test_every_cell_loads_with_its_files_and_limits():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert set(cell.cell["limits"]) == set(check.NAMES)
        assert len(cell.config["devices"]) >= w["chips"]
        assert {"warmup_sweeps", "profiled_sweeps",
                "traced_sweeps"} <= set(cell.traffic)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert cell.per_layer
        for key in cell.config["reduced"]:
            assert key in cell.config


def test_every_metric_reader_loads():
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_the_quarter_rule_on_four_chips():
    bench = json.loads(json.dumps(BENCH))
    for k in range(2):
        bench["workloads"].append(dict(bench["workloads"][-1],
                                       name=f"x{k}.4chip", chips=4,
                                       traffic=f"other{k}"))
    assert any("on 4 chips" in p for p in spec.problems(bench))


def test_names_and_units():
    assert spec.NAME_RE.match("dispatch_ms.train")
    for bad in ("a b", "a,b", "a/b", "", "x" * 65, ".x"):
        assert not spec.NAME_RE.match(bad)
    assert spec.UNIT_RE.match("tokens/s") and spec.UNIT_RE.match("%")
    assert not spec.UNIT_RE.match("tokens per second")


def test_a_new_cell_file_is_picked_up_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "chipbench"
    (base / "traffic" / "sweep_warm10.json").write_text(json.dumps(
        {"warmup_sweeps": 10, "profiled_sweeps": 2, "traced_sweeps": 1}))
    (base / "workloads" / "amazon-r32.1chip.warm10.json").write_text(
        json.dumps({"why": "ten warm-up sweeps",
                    "limits": dict.fromkeys(check.NAMES, 1e-3)}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "amazon-r32.1chip.warm10", "config": "amazon-r32",
        "traffic": "sweep_warm10", "chips": 1,
        "why": "the steady sweep after ten warm-up sweeps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.name: p.read_bytes() for p in ROOT.glob("chipbench/*.py")}
    cell = spec.load_cell("amazon-r32.1chip.warm10", tmp_path)
    assert cell.traffic["warmup_sweeps"] == 10
    assert cell.config["name"] == "amazon-r32"
    assert spec.problems(bench, tmp_path) == []
    assert {p.name: p.read_bytes()
            for p in ROOT.glob("chipbench/*.py")} == before


@pytest.mark.parametrize("tests", [None, {"scale": 1e-5},
                                   {"scale": 0, "mode_scale": 1e-5},
                                   {"scale": 1e-5, "mode_scale": 2.0}])
def test_a_configuration_without_a_tests_size_is_named(tmp_path, tests):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = BENCH["configs"][0]["name"]
    path = tmp_path / BENCH["configs"][0]["file"]
    conf = json.loads(path.read_text())
    del conf["tests"]
    if tests is not None:
        conf["tests"] = tests
    path.write_text(json.dumps(conf))
    assert spec.problems(BENCH, tmp_path) == [
        f"configuration {name} states no tests size: tests.scale and "
        f"tests.mode_scale in (0, 1]"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = list((ROOT / "chipbench").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f


def test_the_reference_imports_only_torch_and_numpy():
    for f in (ROOT / "chipbench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= {"__future__", "functools", "numpy", "torch"}, f
