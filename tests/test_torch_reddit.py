"""The port's normal path on a Reddit-shaped tensor over four devices.

Reddit (AMPED Table 3; FROSTT ``reddit-2015``) is 8,211,298 × 176,962 ×
8,116,559, drawn Zipf(1.05) by the benchmark's generator
(``chipbench/traffic/tensor.py``) with each mode's tail folded onto its
last index. Here it is cut as the configuration
``chipbench/configs/reddit-r32.json`` states under ``tests``: its mode
sizes to 1e-3 (8,211 × 177 × 8,117) and its draws to 2e-6 (9,375, about
3,650 nonzeros). At that cut the folded tail holds more than half of each
mode, so the ``sorted`` preset replicates every mode twice (r = 2: the
merge and the gather); the card's cell, at 1e-2 of the draws over the
published mode sizes, keeps r = 1 (the gather alone). Both run here, on
four logical devices.

``api.plan`` → ``api.compile`` → ``CPSolver.sweep`` runs one sweep from
seeded random factors, against the plain float64 sweep of
``chipbench/reference/cp_als.py`` (torch alone) from the same factors.
Over seeds 0-11, at both replications, the widest gaps read 4.8e-5
(factor entries, as a share of the mode's largest), 3.1e-5 (``lam``) and
3.8e-7 (the fit): float32 sums over the hot rows' thousands of nonzeros.
The tolerances are about seven times those. A sweep whose gather leaves
out one device's block reads factor gaps of order 1 (the left-out rows
are zero in every replica).

The same runs on four cards are marked ``gpu`` and skip with fewer:

    python -m pytest -q -m gpu tests/test_torch_reddit.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch import comm, obs  # noqa: E402
from repro_torch.comm import volume  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.core.mttkrp import cp_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8_211_298, 176_962, 8_116_559)
NNZ = 4_687_474_081
SCALE, MODE_SCALE = 2e-6, 1e-3
RANK = 32
DEVICES = 4
FACTOR_TOL = 3.5e-4
LAM_TOL = 2.5e-4
FIT_TOL = 2.5e-6
# partition.replication: the card's cell (1), and the preset's pick (2 here)
REPLICATIONS = {"r1": 1, "preset": None}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_gen = _load("reddit_tensor_generator", "chipbench/traffic/tensor.py")
_ref = _load("reddit_cp_als_reference", "chipbench/reference/cp_als.py")


def _widest(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def _plan(seed, replication):
    shape, draws = _gen.scaled_geometry(SHAPE, NNZ, SCALE, MODE_SCALE)
    ind, val = _gen.draw_coo(shape, draws, distribution="zipf",
                             zipf_a=1.05, seed=seed, device="cpu")
    t = SparseTensor(ind, val, shape)
    over = {"rank": RANK, "runtime.num_devices": DEVICES,
            "runtime.seed": seed, "kernel.autotune": False,
            "partition.tile": 8, "partition.block_p": 128}
    if replication is not None:
        over["partition.replication"] = replication
    cfg = api.preset("sorted", over)
    return t, cfg, api.plan(t, cfg, device="cpu")


def _solver(plan, cfg, devices):
    return api.compile(plan, cfg, mesh=cp_mesh(DEVICES, plan.modes[0].r,
                                               devices=devices))


def _gaps(seed, replication, devices):
    t, cfg, plan = _plan(seed, replication)
    rng = np.random.default_rng(seed)
    factors = [rng.standard_normal((s, RANK)).astype(np.float32)
               for s in t.shape]
    with _solver(plan, cfg, devices) as solver:
        solver.load_state(factors, np.ones(RANK, np.float32))
        solver.sweep()
        out = solver.result()
    ref_factors, ref_lam, ref_fit = _ref.sweep(t.indices, t.values, factors)
    return (max(_widest(g, w) for g, w in zip(out.factors, ref_factors)),
            _widest(out.lam, ref_lam), abs(out.fits[-1] - ref_fit))


def _replicas_after(seed, replication, devices, sweeps=3):
    """Every replica's factors and ``lam`` after ``sweeps`` sweeps, on the
    host."""
    _, cfg, plan = _plan(seed, replication)
    with _solver(plan, cfg, devices) as solver:
        for _ in range(sweeps):
            solver.sweep()
        state = solver.state
        return ([[f.cpu().numpy() for f in mode] for mode in state.factors],
                [x.cpu().numpy() for x in state.lam])


def _assert_replicas_bitwise(factors, lam):
    for mode in factors:
        assert len(mode) == DEVICES
        for f in mode[1:]:
            np.testing.assert_array_equal(f, mode[0])
    for x in lam[1:]:
        np.testing.assert_array_equal(x, lam[0])


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_the_plan_picks_one_replication_for_every_mode(replication):
    _, _, plan = _plan(1, REPLICATIONS[replication])
    rs = {p.r for p in plan.modes}
    assert rs == ({1} if replication == "r1" else {2})
    assert all(p.num_devices == DEVICES for p in plan.modes)


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_sweep_is_the_float64_reference_sweep(seed, replication):
    factor_gap, lam_gap, fit_gap = _gaps(seed, REPLICATIONS[replication],
                                         ["cpu"] * DEVICES)
    assert factor_gap <= FACTOR_TOL
    assert lam_gap <= LAM_TOL
    assert fit_gap <= FIT_TOL


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_the_four_replicas_hold_the_same_bits(replication):
    _assert_replicas_bitwise(*_replicas_after(
        3, REPLICATIONS[replication], ["cpu"] * DEVICES))


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_the_sent_bytes_counters_are_the_volumes_count_and_model(
        replication):
    _, cfg, plan = _plan(4, REPLICATIONS[replication])
    with _solver(plan, cfg, ["cpu"] * DEVICES) as solver:
        solver.sweep()
        obs.reset()
        volume.reset_sent_bytes()
        solver.sweep()
        counters = obs.get_registry().report()["counters"]
    model = volume.modelled_exchange_bytes(plan, RANK)["per_mode"]
    counted = volume.sent_bytes(DEVICES)
    r = plan.modes[0].r
    for k in range(DEVICES):
        for kind in ("gather", "merge"):
            got = counters.get(f"comm.sent_bytes.{kind}.dev{k}", 0)
            assert got == counted[k][f"{kind}_bytes"]
            assert got == sum(m[f"{kind}_bytes"] for m in model)
        assert counters[f"comm.sent_bytes.gather.dev{k}"] > 0
        assert (counters.get(f"comm.sent_bytes.merge.dev{k}", 0) > 0) \
            == (r > 1)
    assert {k for k in counters if k.startswith("comm.sent_bytes.")} == {
        f"comm.sent_bytes.{kind}.dev{k}" for k in range(DEVICES)
        for kind in (("gather", "merge") if r > 1 else ("gather",))}


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_the_partition_gauges_are_the_plans(replication):
    t, cfg, plan = _plan(5, REPLICATIONS[replication])
    obs.reset()
    with _solver(plan, cfg, ["cpu"] * DEVICES):
        gauges = obs.get_registry().report()["gauges"]
    for d, part in enumerate(plan.modes):
        for k in range(DEVICES):
            assert gauges[f"partition.nnz.mode{d}.dev{k}"] \
                == int(part.nnz_true[k])
        assert gauges[f"partition.padded_rows.mode{d}"] \
            == part.n_groups * part.rows_max == plan.padded_sizes[d]
        assert sum(gauges[f"partition.nnz.mode{d}.dev{k}"]
                   for k in range(DEVICES)) == t.nnz


def _one_block_left_out(orig):
    """The gather with device 1's block zero in every replica."""
    def gather(xs, mesh, axis_names, **kw):
        full = orig(xs, mesh, axis_names, **kw)
        n = xs[0].shape[0]
        out = []
        for f in full:
            g = f.clone()
            g[n:2 * n] = 0
            out.append(g)
        return out
    return gather


@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_a_block_left_out_of_the_gather_breaks_the_tolerances(
        monkeypatch, replication):
    monkeypatch.setattr(comm, "all_gather_axes",
                        _one_block_left_out(comm.all_gather_axes))
    factor_gap, _, _ = _gaps(0, REPLICATIONS[replication],
                             ["cpu"] * DEVICES)
    assert factor_gap > 10 * FACTOR_TOL


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < DEVICES:
        pytest.skip(f"needs {DEVICES} CUDA cards")
    return [f"cuda:{k}" for k in range(DEVICES)]


@pytest.mark.gpu
@pytest.mark.parametrize("replication", sorted(REPLICATIONS))
def test_four_cards_sweep_the_reference_and_hold_the_same_bits(
        four_cards, replication):
    factor_gap, lam_gap, fit_gap = _gaps(0, REPLICATIONS[replication],
                                         four_cards)
    assert factor_gap <= FACTOR_TOL
    assert lam_gap <= LAM_TOL
    assert fit_gap <= FIT_TOL
    _assert_replicas_bitwise(*_replicas_after(
        3, REPLICATIONS[replication], four_cards))
