"""CPU tests of the benchmark harness: ``python -m pytest chipbench/tests
-q`` from the repository's root."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The limits at the tests' size, a few thousand nonzeros a cell, which each
# configuration states under ``tests`` (the cells' own limits are set on
# the card at the timed size).
TINY_LIMITS = {"factor_gap": 4e-4, "lam_gap": 8e-4, "fit_gap": 5e-5,
               "end_solve_gap": 1e-5}
# A cell of four logical devices that the tests add beside the
# benchmark's: the harness's path across devices, with its exchange.
FOUR = "amazon-r32.4dev"


def make_tiny_root(dest: Path, src: Path = ROOT) -> Path:
    """A copy of ``BENCHMARK.json`` and ``chipbench/`` of ``src`` with
    every configuration cut to its own ``tests`` size, and the cell
    ``FOUR``."""
    shutil.copy(src / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(src / "chipbench", dest / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = dest / "chipbench"
    for p in (base / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["scale"] = c["tests"]["scale"]
        c["mode_scale"] = c["tests"]["mode_scale"]
        p.write_text(json.dumps(c))
    for p in (base / "workloads").glob("*.json"):
        c = json.loads(p.read_text())
        c["limits"] = dict(TINY_LIMITS)
        p.write_text(json.dumps(c))
    conf = json.loads((base / "configs" / "amazon-r32.json").read_text())
    conf["devices"] = [f"cuda:{k}" for k in range(4)]
    (base / "configs" / f"{FOUR}.json").write_text(json.dumps(conf))
    (base / "workloads" / f"{FOUR}.json").write_text(json.dumps(
        {"why": "four logical devices", "limits": dict(TINY_LIMITS)}))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": FOUR, "source": "tests",
                             "file": f"chipbench/configs/{FOUR}.json",
                             "reduced": ["scale"], "why": "tests"})
    bench["workloads"].append({"name": FOUR, "config": FOUR,
                               "traffic": "sweep_fit_each", "chips": 4,
                               "why": "tests"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
