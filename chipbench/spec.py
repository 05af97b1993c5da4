"""What a cell is made of, found by name from ``BENCHMARK.json``.

- ``BENCHMARK.json`` lists the configurations, cells and metrics;
- ``chipbench/configs/<config>.json``: the deployment, its logical
  devices among them (the file that ``BENCHMARK.json`` names), and under
  ``tests`` the cuts of ``scale`` and ``mode_scale`` that the CPU tests
  run it at (a run never reads them);
- ``chipbench/workloads/<cell>.json``: the cell's description and the
  limits of its comparison;
- ``chipbench/traffic/<traffic>.json``: the loop the window runs;
- ``chipbench/metrics/<metric>.py``: one reader per per-layer metric.

A cell, a traffic mix, a configuration or a metric is added by adding its
file and its entry; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["ROOT", "Cell", "load_benchmark", "load_cell", "metric_reader",
           "NAME_RE", "UNIT_RE", "problems"]

ROOT = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # configs/<config>.json
    cell: dict           # workloads/<cell>.json
    traffic: dict        # traffic/<traffic>.json
    end_to_end: list     # the end-to-end metrics this cell reports
    per_layer: list      # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = root / "chipbench"

    def load(path):
        with open(path) as f:
            return json.load(f)

    return Cell(
        name=name, entry=entry,
        config=load(root / conf["file"]),
        cell=load(base / "workloads" / f"{name}.json"),
        traffic=load(base / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``chipbench/metrics/<name>.py``."""
    path = Path(root) / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _states_tests_size(conf: dict) -> bool:
    tests = conf.get("tests")
    return isinstance(tests, dict) and all(
        isinstance(tests.get(k), (int, float)) and 0 < tests[k] <= 1
        for k in ("scale", "mode_scale"))


def problems(bench: dict, root: Path = ROOT) -> list[str]:
    """What in ``bench`` breaks the benchmark's own rules: names, units,
    one file per configuration, cell and metric, a tests size in every
    configuration, and at most a quarter of the cells (rounded down, at
    least one) on four chips."""
    out = []
    base = Path(root) / "chipbench"
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    for kind, items in (("config", bench["configs"]),
                        ("cell", bench["workloads"]), ("metric", metrics)):
        seen = [i["name"] for i in items]
        for n in seen:
            if not NAME_RE.match(n):
                out.append(f"{kind} name {n!r}")
        if len(set(seen)) != len(seen):
            out.append(f"duplicate {kind} names")
    for m in metrics:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}")
        if not (base / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"no reader for {m['name']}")
    files = [c["file"] for c in bench["configs"]]
    if len(set(files)) != len(files):
        out.append("two configurations share a file")
    for c in bench["configs"]:
        path = Path(root) / c["file"]
        if not path.is_file():
            out.append(f"no file for configuration {c['name']}")
        elif not _states_tests_size(json.loads(path.read_text())):
            out.append(f"configuration {c['name']} states no tests size: "
                       f"tests.scale and tests.mode_scale in (0, 1]")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                out.append(f"reduced key {k!r}")
    confs = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    if used != confs:
        out.append(f"configurations without a cell: {sorted(confs - used)}")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a configuration and traffic pair appears twice")
    for w in bench["workloads"]:
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']} asks for {w['chips']} chips")
        if not NAME_RE.match(w["traffic"]):
            out.append(f"traffic name {w['traffic']!r}")
        for f in (base / "workloads" / f"{w['name']}.json",
                  base / "traffic" / f"{w['traffic']}.json"):
            if not f.is_file():
                out.append(f"no file {f.relative_to(root)}")
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            out.append(f"why of {w['name']}")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    if four > max(1, len(bench["workloads"]) // 4):
        out.append(f"{four} of {len(bench['workloads'])} cells on 4 chips")
    if "setup_s" not in names:
        out.append("no setup_s")
    return out
