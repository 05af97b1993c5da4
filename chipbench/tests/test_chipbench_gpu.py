"""The same runs on the card at the tests' size (marked ``gpu``; they skip
without a card):

    python -m pytest -q -m gpu chipbench/tests/test_chipbench_gpu.py
"""
from __future__ import annotations

import time

import pytest
import torch

from chipbench import check, harness, spec

pytestmark = pytest.mark.gpu
CELLS = [w for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_card_run_is_correct_and_the_control_is_not(card, tiny_root, cell):
    chips = next(w["chips"] for w in CELLS if w["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")
    r = harness.run(cell, 2**32 + 9, 0.5, True, t_start=time.perf_counter(),
                    root=tiny_root, control=True, log=lambda msg: None)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert {"ec_ms", "ec_roofline", "device_idle_pct"} <= set(r["metrics"])
    assert 0 < r["metrics"]["ec_roofline"]["value"] <= 100
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    assert not check.judge(r["control"], limits)
