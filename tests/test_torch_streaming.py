"""Epoch streaming in the port (``runtime.streaming`` on a tensor-store
plan) on the CPU.

Held bitwise inside the port: a streamed run's fits and factors equal the
same lazy plan run resident, for every EC variant, under a budget that
splits every mode into several super-shards, on one device and on 4
logical CPU devices (replicas bitwise equal too). That includes a window
whose trailing pad blocks lengthen its last tile's run past
``CHUNK_BLOCKS`` (the two-level order then adds exact zeros). Held against
the reference: the streamed fits to 1e-4 of the reference's streamed run
on the same store (the tolerance of tests/test_torch_als.py: the two
packages' eigh and matmul round differently), on one device and, in one
subprocess with 4 JAX CPU devices, on four.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.api as japi  # noqa: E402
from repro import store as jst  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import mttkrp as dm  # noqa: E402
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import decompose as launcher  # noqa: E402
from repro_torch.store import (TensorStore, budget_slot_cap,  # noqa: E402
                               build_plan_from_store, resident_shard_nbytes,
                               split_mode_super_shards, write_store_from_coo)

R = 8
SWEEPS = 3
VARIANTS = {"paper": {}, "sorted": {"kernel.autotune": False},
            "fused": {"kernel.autotune": False},
            "optimized": {"partition.replication": 1}}


def _wide_tensor():
    return random_sparse((400, 300, 200), 12000, seed=7, dedup=False)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    t = _wide_tensor()
    path = str(tmp_path_factory.mktemp("wide") / "w.store")
    write_store_from_coo(t, path, chunk_nnz=1024)
    return path


def _budget(parts, frac=0.2, buffers=2):
    """A fraction of the modes' resident shard bytes, never below a mode's
    densest-tile or chunk-staging floor (tests/test_streaming.py's)."""
    nmodes = parts[0].nmodes
    total = sum(resident_shard_nbytes(p, nmodes) for p in parts)
    floors = []
    for p in parts:
        per_slot = 4 * nmodes + 8 + 4 / p.block_p
        dense = int(p._dev_tc_pad.max()) if p._dev_tc_pad.size else 0
        floors.append(buffers * int(max(dense, p.block_p) * per_slot
                                    + p.layout.n_tiles * 4 + 1))
        floors.append(p.store.chunk_nnz * (8 * nmodes + 4))
    return max(int(total * frac), *floors)


def _run(plan, cfg, mesh=None, sweeps=SWEEPS):
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    with tapi.compile(plan, cfg, **kw) as solver:
        res = solver.run(sweeps)
        state = solver.state
        report = solver.overlap_report()
    return res, state, report


def _assert_same(res_a, res_b):
    assert res_a.fits == res_b.fits
    for a, b in zip(res_a.factors, res_b.factors, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_a.lam, res_b.lam)


@pytest.mark.parametrize("preset", sorted(VARIANTS))
def test_streamed_equals_resident_one_device(wide, preset):
    cfg = tapi.preset(preset, {"rank": R, "runtime.tol": 0.0,
                               "runtime.num_devices": 1,
                               **VARIANTS[preset]})
    store = TensorStore(wide)
    plan = tapi.plan(store, cfg, device="cpu")
    budget = _budget(plan.modes)
    scfg = cfg.with_overrides({"runtime.streaming": True,
                               "runtime.memory_budget": budget})
    resident, _, _ = _run(plan, cfg)
    _build.reset_launch_counts()
    streamed, _, report = _run(plan, scfg)
    _assert_same(streamed, resident)
    assert min(report["shards_per_mode"]) >= 3
    assert report["peak_resident_bytes"] <= budget
    assert report["spill_saves"] > 0 and report["spill_hits"] > 0
    assert len(report["per_sweep"]) == SWEEPS
    # every window is placed once a sweep; the last window's prefetch of
    # the next sweep's first one may have finished by the report or not
    sweep_bytes = sum(n * b for n, b in zip(report["shards_per_mode"],
                                            report["shard_bytes_per_mode"]))
    assert report["bytes_streamed"] - SWEEPS * sweep_bytes in \
        (0, report["shard_bytes_per_mode"][0])
    assert sum(_build.LAUNCHES.values()) == 0  # plain versions on the CPU


@pytest.mark.parametrize("preset", ["paper", "sorted"])
def test_streamed_fits_match_reference(wide, preset):
    over = {"rank": R, "runtime.tol": 0.0, "runtime.num_devices": 1,
            "kernel.autotune": False}
    tcfg = tapi.preset(preset, over)
    tplan = tapi.plan(TensorStore(wide), tcfg, device="cpu")
    budget = _budget(tplan.modes)
    stream = {"runtime.streaming": True, "runtime.memory_budget": budget}
    sweeps = 2 if preset == "paper" else 1  # interpret-mode sorted: 1
    res, _, _ = _run(tplan, tcfg.with_overrides(stream), sweeps=sweeps)
    jcfg = japi.preset(preset, {**over, **stream})
    with japi.compile(japi.plan(jst.TensorStore(wide), jcfg), jcfg) as js:
        assert [sp.num_shards for sp in js.stream_plans] == \
            [sp.num_shards for sp in split_mode_super_shards_all(tplan,
                                                                 budget)]
        jres = js.run(sweeps)
    np.testing.assert_allclose(res.fits, jres.fits, atol=1e-4)


def split_mode_super_shards_all(plan, budget):
    return [split_mode_super_shards(p, budget) for p in plan.modes]


def _pad_split_case(tmp_path):
    """Mode 0: tile 0 holds 40 blocks of block_p=16, tile 1 holds 10. A
    budget of one 40-block super-shard puts tile 1 alone in the second
    window, whose 30 trailing pad blocks revisit tile 1: a 10-block run in
    the resident shard becomes a 40-block run in the window."""
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.integers(0, 8, 640), rng.integers(8, 16, 160)])
    ind = np.stack([rows, rng.integers(0, 64, 800), rng.integers(0, 48, 800)],
                   axis=1).astype(np.int32)
    t = SparseTensor(ind, rng.standard_normal(800).astype(np.float32),
                     (16, 64, 48))
    path = str(tmp_path / "pads.store")
    write_store_from_coo(t, path, chunk_nnz=64)
    return path


def _runs(b2t):
    starts = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    return dict(zip(b2t[starts[:-1]].tolist(), np.diff(starts).tolist()))


@pytest.mark.parametrize("variant", ["ref", "sorted", "fused", "blocked"])
def test_trailing_pads_split_the_last_tiles_run(tmp_path, variant):
    path = _pad_split_case(tmp_path)
    layout = "sorted" if variant == "sorted" else "blocked"
    plan = build_plan_from_store(TensorStore(path), 1, tile=8, block_p=16,
                                 layout=layout)
    part = plan.modes[0]
    n_tiles = part.rows_max // part.tile
    budget = next(b for b in range(4096, 1 << 20, 4)
                  if budget_slot_cap(b, nmodes=3, n_tiles=n_tiles,
                                     block_p=16) >= 640)
    sp = split_mode_super_shards(part, budget)
    assert sp.windows[0] == ((0, 1), (1, n_tiles)) and sp.nblocks == 40
    mesh = dm.cp_mesh(1, 1, devices=["cpu"])
    resident = dm.shard_plan_mode(part, mesh)
    window = dm.shard_super_shard(part, sp, 1, mesh).arrays
    assert _runs(resident[0].block_to_tile.numpy())[1] == 10
    assert _runs(window[0].block_to_tile.numpy())[1] == 40
    assert _build.CHUNK_BLOCKS < 40
    rng = np.random.default_rng(1)
    factors = [[torch.from_numpy(rng.normal(size=(p.padded_rows, R)).astype(
        np.float32))] for p in plan.modes]
    kw = dict(use_kernel=variant != "ref", variant=variant)
    want = dm.make_mttkrp_fn(part, mesh, **kw).local(resident, factors)[0]
    acc = dm.zero_partials(part, mesh, R)
    pfn = dm.make_partial_mttkrp_fn(part, mesh, **kw)
    for k in range(sp.num_shards):
        acc = pfn(acc, dm.shard_super_shard(part, sp, k, mesh).arrays,
                  factors)
    assert torch.equal(acc[0], want)
    cfg = tapi.preset("paper", {"rank": R, "runtime.tol": 0.0,
                                "kernel.use_kernel": variant != "ref",
                                "kernel.variant": variant,
                                "partition.layout": layout})
    res, _, _ = _run(plan, cfg)
    sres, _, _ = _run(plan, cfg.with_overrides({
        "runtime.streaming": True, "runtime.memory_budget": budget}))
    _assert_same(sres, res)


def test_streaming_refusals(wide):
    t = _wide_tensor()
    cfg = tapi.paper({"rank": 4, "runtime.streaming": True,
                      "runtime.memory_budget": 1 << 20})
    with pytest.raises(ValueError, match="out-of-core plan"):
        tapi.compile(tapi.plan(t, cfg, device="cpu"), cfg, device="cpu")
    lazy = tapi.plan(TensorStore(wide), cfg, device="cpu")
    with pytest.raises(ValueError, match="memory_budget"):
        tapi.compile(lazy, tapi.paper({"rank": 4,
                                       "runtime.streaming": True}),
                     device="cpu")
    with pytest.raises(ValueError, match="in-memory plan"):
        tapi.compile(lazy, tapi.paper({"schedule.rebalance": "measure"}),
                     device="cpu")
    with tapi.compile(lazy, cfg, device="cpu") as solver:
        with pytest.raises(RuntimeError, match="streaming mode"):
            solver.dev_arrays  # noqa: B018
        assert "counted_skipped" in solver.exchange_report()


def test_launcher_streams_a_store(wide, capsys):
    launcher.main(["--store", wide, "--stream", "--memory-budget-mb", "0.25",
                   "--device", "cpu", "--iters", "2", "--rank", "4",
                   "--set", "runtime.tol=0"])
    out = capsys.readouterr().out
    assert f"store {wide}: shape=(400, 300, 200) nnz=12000" in out
    assert "streaming: budget 0.2 MiB/dev x2 buffers" in out
    assert "sweep 2: fit=" in out and "window spill:" in out


SCRIPT = r"""
import sys
import numpy as np, jax
import repro.api as api
from repro.store import TensorStore
assert jax.device_count() == 4, jax.device_count()
path, budget, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cfg = api.preset("paper", {"rank": 8, "runtime.tol": 0.0,
                           "runtime.num_devices": 4,
                           "partition.replication": 2,
                           "runtime.streaming": True,
                           "runtime.memory_budget": budget})
with api.compile(api.plan(TensorStore(path), cfg), cfg) as solver:
    res = solver.run(3)
    shards = [sp.num_shards for sp in solver.stream_plans]
np.savez(out, fits=np.asarray(res.fits), shards=np.asarray(shards))
print("done")
"""


def test_four_logical_devices_streamed_equals_resident(wide, tmp_path):
    """4 logical CPU devices at r = 2 (the merge runs): streamed equals
    resident bitwise, every replica holds the same bits, and the fits are
    within 1e-4 of the reference's streamed run on 4 JAX CPU devices."""
    cfg = tapi.preset("paper", {"rank": R, "runtime.tol": 0.0,
                                "runtime.num_devices": 4,
                                "partition.replication": 2})
    plan = tapi.plan(TensorStore(wide), cfg, device="cpu")
    budget = _budget(plan.modes, frac=0.08)
    mesh = dm.cp_mesh(4, 2, devices=["cpu"] * 4)
    resident, _, _ = _run(plan, cfg, mesh=mesh)
    streamed, state, report = _run(plan, cfg.with_overrides({
        "runtime.streaming": True, "runtime.memory_budget": budget}),
        mesh=mesh)
    _assert_same(streamed, resident)
    for reps in state.factors + state.grams + [state.lam,
                                               state.replica_fits]:
        for x in reps[1:]:
            assert torch.equal(reps[0], x)
    assert min(report["shards_per_mode"]) >= 2
    assert report["peak_resident_bytes"] <= budget
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, wide, str(budget),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    assert ref["shards"].tolist() == report["shards_per_mode"]
    np.testing.assert_allclose(streamed.fits, ref["fits"], atol=1e-4)
