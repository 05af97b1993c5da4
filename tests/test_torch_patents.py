"""The port's normal path on a Patents-shaped tensor, on the CPU.

Patents (AMPED Table 3; FROSTT ``patents``) is 46 × 239,172 × 239,172,
drawn uniformly by the repo's stand-in. Here its term modes are cut to
2,392 rows and its nonzeros to 20,000, and its 46-row year mode is kept:
at tile 8 and block_p 128 that mode is 6 tiles of about 3,500 nonzeros,
each one run of more than ``CHUNK_BLOCKS`` blocks, so its whole EC runs on
the split path (work items writing partials, added in item order).

``api.plan`` → ``api.compile`` → ``CPSolver.sweep`` with the ``sorted``
preset runs one sweep from seeded random factors, against the plain
float64 sweep of ``chipbench/reference/cp_als.py`` (torch alone, no JAX)
from the same factors. Over seeds 0-11 the widest gaps read 1.5e-6
(factor entries and ``lam``, as a share of the largest) and 8.6e-8 (the
fit): float32 sums of a few thousand terms a row. The tolerances are about
seven times those: 1e-5 and 1e-6. A sweep without the first work item of
each launch (the year mode's first partial dropped) reads factor and
``lam`` gaps of 1.0 and 0.15 on seed 0, far above them.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mttkrp_sorted  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (46, 2392, 2392)
NNZ = 20_000
RANK = 32
FACTOR_TOL = 1e-5
LAM_TOL = 1e-5
FIT_TOL = 1e-6


def _reference():
    spec = importlib.util.spec_from_file_location(
        "patents_cp_als_reference",
        ROOT / "chipbench" / "reference" / "cp_als.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _widest(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _plan(seed):
    t = random_sparse(SHAPE, NNZ, seed=seed, distribution="uniform")
    cfg = api.preset("sorted", {
        "rank": RANK, "runtime.num_devices": 1, "runtime.seed": seed,
        "kernel.autotune": False, "partition.tile": 8,
        "partition.block_p": 128})
    return t, cfg, api.plan(t, cfg, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_year_mode_runs_wholly_on_the_split_path(seed):
    _, _, plan = _plan(seed)
    year = plan.modes[0]
    assert year.num_devices == 1 and year.tile == 8
    b2t = torch.from_numpy(year.block_to_tile[0])
    chunks = _build.tile_chunks(b2t)
    runs = chunks.split[:, chunks.split[0] >= 0]
    assert runs.shape[1] == 6
    assert sorted(runs[2].tolist()) == list(range(6))
    slots, partials = _build.split_slots(chunks, year.block_p)
    assert slots == year.values[0].size
    assert partials == int(runs[1].sum()) >= 2 * 6
    for mode in plan.modes[1:]:
        assert _build.split_slots(_build.tile_chunks(torch.from_numpy(
            mode.block_to_tile[0])), mode.block_p) == (0, 0)


def _gaps(seed, monkeypatch=None, fault=None):
    """The widest gaps of one sweep from seeded random factors against the
    reference's, with ``fault`` (a wrapper of the sorted EC's two-level
    sum) patched in."""
    cp_als = _reference()
    t, cfg, plan = _plan(seed)
    if fault is not None:
        monkeypatch.setattr(mttkrp_sorted, "ec_rows_chunked",
                            fault(mttkrp_sorted.ec_rows_chunked))
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((s, RANK)).astype(np.float32)
               for s in SHAPE]
    with api.compile(plan, cfg, device="cpu") as solver:
        assert obs.get_registry().gauge("ec.split_slot_share.mode0") == 1.0
        solver.load_state(factors, np.ones(RANK, np.float32))
        solver.sweep()
        out = solver.result()
    ref_factors, ref_lam, ref_fit = cp_als.sweep(t.indices, t.values,
                                                 factors)
    return (max(_widest(g, w) for g, w in zip(out.factors, ref_factors)),
            _widest(out.lam, ref_lam), abs(out.fits[-1] - ref_fit))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_sweep_is_the_float64_reference_sweep(seed):
    factor_gap, lam_gap, fit_gap = _gaps(seed)
    assert factor_gap <= FACTOR_TOL
    assert lam_gap <= LAM_TOL
    assert fit_gap <= FIT_TOL


def _drop_first_item(orig):
    """The EC without the first work item of each launch: the year mode
    loses the partial of its first split run's first item."""
    def chunked(values, *args, block_p, chunk_blocks, **kw):
        v = values.clone()
        v[:chunk_blocks * block_p] = 0
        return orig(v, *args, block_p=block_p, chunk_blocks=chunk_blocks,
                    **kw)
    return chunked


def test_a_dropped_partial_breaks_the_tolerances(monkeypatch):
    factor_gap, lam_gap, _ = _gaps(0, monkeypatch, _drop_first_item)
    assert factor_gap > 10 * FACTOR_TOL and lam_gap > 10 * LAM_TOL
