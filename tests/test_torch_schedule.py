"""The port's scheduling subsystem (repro_torch.schedule) against the
reference's (repro.schedule) on the same inputs, on the CPU.

Held bitwise: the cost model (features, stream bytes, predictions, the
non-negative least-squares refit, the EWMA calibration, exchange bytes, the
per-mode summary), migration planning (identical ``GroupMigration``
tuples) and the incremental apply (every array of the new plan, the
``applied`` records, and the same refusals: a stale epoch, no headroom, and
an entry whose stored value is an explicit 0.0). The probe runs every EC
variant on block-trimmed shards, ``sorted`` with descriptors computed for
the trimmed rows (the reference's probe has none for it and raises), and
equals the full shard's EC on the tiles it visits. A ``"measure"`` run on
4 logical CPU devices leaves factors and fits bitwise equal to ``"off"``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from _torch_cases import skewed_tensor  # noqa: E402
from repro.core import coo as j_coo  # noqa: E402
from repro.core import partition as j_part  # noqa: E402
from repro.schedule import cost as j_cost  # noqa: E402
from repro.schedule import rebalance as j_reb  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch import schedule as t_schedule  # noqa: E402
from repro_torch.core import coo as t_coo  # noqa: E402
from repro_torch.core import mttkrp as t_dm  # noqa: E402
from repro_torch.core import partition as t_part  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import decompose as launcher  # noqa: E402
from repro_torch.schedule import cost as t_cost  # noqa: E402
from repro_torch.schedule import rebalance as t_reb  # noqa: E402


def _both_plans(t, *, strategy="equal_nnz", devices=4, replication=None,
                layout="blocked"):
    kw = dict(strategy=strategy, replication=replication, layout=layout)
    jp = j_part.build_plan(j_coo.SparseTensor(t.indices, t.values, t.shape),
                           devices, **kw)
    tp = t_part.build_plan(t_coo.SparseTensor(t.indices, t.values, t.shape),
                           devices, **kw)
    return jp, tp


def _assert_same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def _assert_same_plan(jp, tp):
    assert jp.rebalance_epoch == tp.rebalance_epoch
    for d, (jm, tm) in enumerate(zip(jp.modes, tp.modes, strict=True)):
        for f in dataclasses.fields(tm):
            _assert_same_value(getattr(jm, f.name), getattr(tm, f.name),
                               f"mode {d} {f.name}")


# -- cost model ---------------------------------------------------------------

COEFFS = [
    dict(),
    dict(sec_per_nnz=2e-9, sec_per_slot=5e-9, sec_fixed=1e-4),
    dict(sec_per_nnz=0.0, sec_per_slot=3e-9, sec_fixed=2e-5,
         sec_per_row=1e-7, sec_per_h2d_byte=1e-10),
]


@pytest.mark.parametrize("coeffs", range(len(COEFFS)))
@pytest.mark.parametrize("strategy,replication", [
    ("equal_nnz", None), ("amped_cdf", 2), ("amped_cdf", 1)])
def test_cost_model_matches_reference(small_tensor, strategy, replication,
                                      coeffs):
    jp, tp = _both_plans(small_tensor, strategy=strategy,
                         replication=replication)
    jc = j_cost.CostCoefficients(**COEFFS[coeffs])
    tc = t_cost.CostCoefficients(**COEFFS[coeffs])
    _assert_same_value(jc.as_array(), tc.as_array(), "as_array")
    hist = small_tensor.mode_histogram(0)
    _assert_same_value(j_cost.index_work(hist, jc),
                       t_cost.index_work(hist, tc), "index_work")
    for jm, tm in zip(jp.modes, tp.modes):
        _assert_same_value(j_cost.device_features(jm),
                           t_cost.device_features(tm), "features")
        _assert_same_value(j_cost.device_stream_bytes(jm, 3),
                           t_cost.device_stream_bytes(tm, 3), "stream bytes")
        for nmodes in (None, 3):
            _assert_same_value(j_cost.predict_times(jm, jc, nmodes=nmodes),
                               t_cost.predict_times(tm, tc, nmodes=nmodes),
                               "predict_times")
            assert j_cost.mode_cost_summary(jm, 8, jc, nmodes=nmodes) == \
                t_cost.mode_cost_summary(tm, 8, tc, nmodes=nmodes)
        for dtype_bytes in (2, 4):
            _assert_same_value(
                j_cost.exchange_bytes(jm, 8, dtype_bytes=dtype_bytes),
                t_cost.exchange_bytes(tm, 8, dtype_bytes=dtype_bytes),
                "exchange_bytes")


def _fit_cases():
    rng = np.random.default_rng(0)
    nnz = rng.integers(1000, 50000, 32).astype(np.float64)
    slots = nnz * rng.uniform(1.0, 3.0, 32)
    lin = np.stack([nnz, slots, np.ones(32)], axis=1)
    rng1 = np.random.default_rng(1)
    neg = np.stack([rng1.uniform(1, 2, 16), rng1.uniform(1e5, 2e5, 16),
                    np.ones(16)], axis=1)
    return {
        "linear": (lin, lin @ np.array([2e-9, 5e-9, 1e-4])),
        "never_negative": (neg, neg[:, 1] * 1e-8),
        "noisy": (lin, lin @ np.array([2e-9, 5e-9, 1e-4])
                  * rng.uniform(0.8, 1.2, 32)),
        "one_device_row": (lin[:1], np.array([3e-4])),
    }


@pytest.mark.parametrize("case", sorted(_fit_cases()))
def test_fit_coefficients_and_ewma_match_reference(case):
    feats, times = _fit_cases()[case]
    assert dataclasses.astuple(j_cost.fit_coefficients(feats, times)) == \
        dataclasses.astuple(t_cost.fit_coefficients(feats, times))
    jm = j_cost.EwmaCostModel(alpha=0.5, coeffs=j_cost.CostCoefficients(
        sec_per_h2d_byte=1e-10))
    tm = t_cost.EwmaCostModel(alpha=0.5, coeffs=t_cost.CostCoefficients(
        sec_per_h2d_byte=1e-10))
    for k in range(3):
        scaled = times * (1.0 + 0.5 * k)
        assert dataclasses.astuple(jm.update(feats, scaled)) == \
            dataclasses.astuple(tm.update(feats, scaled))
    assert jm.calibrated and tm.calibrated


def test_ewma_cost_model_smooths():
    """tests/test_schedule.py's EWMA midpoint, on the port."""
    m = t_cost.EwmaCostModel(alpha=0.5)
    feats = np.array([[100.0, 200.0, 1.0], [50.0, 400.0, 1.0],
                      [10.0, 900.0, 1.0]])
    c1 = m.update(feats, feats @ np.array([1e-9, 2e-9, 0.0]))
    assert c1.sec_per_slot == pytest.approx(2e-9, rel=1e-6)
    c2 = m.update(feats, feats @ np.array([1e-9, 4e-9, 0.0]))
    assert c2.sec_per_slot == pytest.approx(3e-9, rel=1e-5)


def test_schedule_package_exports_the_reference_names():
    import repro.schedule as j_schedule
    assert set(t_schedule.__all__) == set(j_schedule.__all__)
    for name in t_schedule.__all__:
        assert getattr(t_schedule, name) is not None


def test_imbalance_ratio_matches_reference():
    for t in ([1.0, 2.0, 2.0, 8.0], [0.0, 0.0], [3.0], []):
        assert j_reb.imbalance_ratio(np.array(t)) == \
            t_reb.imbalance_ratio(np.array(t))


# -- migration planning -------------------------------------------------------

MIGRATION_CASES = {
    # tests/test_schedule.py:153-186, plus the streaming budget clamp
    "budgeted": ("equal_nnz", None, [1.0, 2.0, 2.0, 8.0], 0.25, None),
    "balanced": ("equal_nnz", None, [1.0, 1.0, 1.0, 1.0], 0.25, None),
    "r1": ("amped_cdf", 1, [1.0, 2.0, 3.0, 4.0], 0.25, None),
    "wide_budget": ("equal_nnz", None, [1.0, 2.0, 2.0, 8.0], 0.4, None),
    "max_member_nnz": ("equal_nnz", None, [1.0, 2.0, 2.0, 8.0], 0.4, 1700),
    "cap_too_small": ("equal_nnz", None, [1.0, 2.0, 2.0, 8.0], 0.4, 900),
    "r2_groups": ("amped_cdf", 2, [1.0, 3.0, 4.0, 1.0], 0.3, None),
}


@pytest.mark.parametrize("case", sorted(MIGRATION_CASES))
def test_plan_group_migrations_matches_reference(case):
    strategy, repl, times, budget, cap = MIGRATION_CASES[case]
    jp, tp = _both_plans(skewed_tensor(), strategy=strategy,
                         replication=repl)
    for jm, tm in zip(jp.modes, tp.modes):
        kw = dict(migration_budget=budget, max_member_nnz=cap)
        want = j_reb.plan_group_migrations(jm, np.array(times), **kw)
        got = t_reb.plan_group_migrations(tm, np.array(times), **kw)
        assert [dataclasses.astuple(m) for m in got] == \
            [dataclasses.astuple(m) for m in want]
    if case in ("balanced", "r1"):
        assert got == []
    if case == "budgeted":
        assert len(got) == 1 and got[0].moved_nnz > 0


# -- incremental apply --------------------------------------------------------

def _decision(mod, plan, migs):
    return mod.ReplanDecision(epoch=plan.rebalance_epoch, sweep=1,
                              triggered=bool(migs), imbalance={},
                              modelled_imbalance={}, migrations=tuple(migs))


def _nonzero_multiset(part):
    mask = part.values != 0
    rows = np.concatenate([part.indices[mask],
                           part.values[mask].view(np.int32)[:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def _migrate_both(t, layout, times=(1.0, 2.0, 2.0, 8.0), budget=0.3):
    jp, tp = _both_plans(t, layout=layout)
    jm = j_reb.plan_group_migrations(jp.modes[0], np.array(times),
                                     migration_budget=budget)
    tm = t_reb.plan_group_migrations(tp.modes[0], np.array(times),
                                     migration_budget=budget)
    return jp, tp, jm, tm


@pytest.mark.parametrize("layout", ["blocked", "sorted"])
def test_apply_rebalance_matches_reference(layout):
    jp, tp, jm, tm = _migrate_both(skewed_tensor(), layout)
    assert tm
    j_new, j_applied = j_reb.apply_rebalance(jp, _decision(j_reb, jp, jm))
    t_new, t_applied = t_reb.apply_rebalance(tp, _decision(t_reb, tp, tm))
    assert t_applied == j_applied
    assert sum(a["moved_nnz"] for a in t_applied) > 0
    assert t_new.rebalance_epoch == tp.rebalance_epoch + 1 == 1
    _assert_same_plan(j_new, t_new)
    # shapes kept, the same nonzeros covered once, the kernels' tile runs
    for f in ("indices", "values", "local_rows", "block_to_tile",
              "tile_visited"):
        assert getattr(t_new.modes[0], f).shape == \
            getattr(tp.modes[0], f).shape
    np.testing.assert_array_equal(_nonzero_multiset(t_new.modes[0]),
                                  _nonzero_multiset(tp.modes[0]))
    t_part.validate_plan(t_new)
    # the sorted descriptors of the migrated shards, as both packages
    # derive them
    for a, b in zip(j_part.block_segment_descriptors(
            j_new.modes[0].local_rows, tile=8, block_p=128),
            t_part.block_segment_descriptors(
            t_new.modes[0].local_rows, tile=8, block_p=128)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["blocked", "sorted"])
def test_apply_rebalance_rejects_stale_epoch(layout):
    _, tp, _, tm = _migrate_both(skewed_tensor(), layout)
    new_plan, _ = t_reb.apply_rebalance(tp, _decision(t_reb, tp, tm))
    with pytest.raises(ValueError, match="epoch"):
        t_reb.apply_rebalance(new_plan, _decision(t_reb, tp, tm))


@pytest.mark.parametrize("layout", ["blocked", "sorted"])
def test_apply_rebalance_headroom_skip_matches_reference(layout):
    """A migration that cannot fit the existing nnz_max is skipped in both
    packages ("no-headroom"): arrays unchanged, epoch bumped. The member
    with the most blocks already fills nnz_max, and every block of entries
    its neighbour hands it opens new tiles; halving the move cannot help."""
    jp, tp = _both_plans(skewed_tensor(), layout=layout)
    part = tp.modes[0]
    recv = int(np.argmax(part.blocks_true))
    assert part.blocks_true[recv] * part.block_p == part.nnz_max
    donor = recv - 1 if recv > 0 else 1
    n = tuple(int(x) for x in part.nnz_true)
    tgt = list(n)
    tgt[recv] += 8 * part.block_p
    tgt[donor] -= 8 * part.block_p
    out = []
    for mod, plan in ((j_reb, jp), (t_reb, tp)):
        mig = mod.GroupMigration(mode=0, group=0, nnz_before=n,
                                 nnz_target=tuple(tgt),
                                 moved_nnz=8 * part.block_p)
        out.append(mod.apply_rebalance(plan, _decision(mod, plan, [mig])))
    (j_new, j_applied), (t_new, t_applied) = out
    assert t_applied == j_applied == [
        {"mode": 0, "group": 0, "moved_nnz": 0, "skipped": "no-headroom"}]
    _assert_same_plan(j_new, t_new)
    assert t_new.rebalance_epoch == 1
    for f in dataclasses.fields(tp.modes[0]):
        _assert_same_value(getattr(tp.modes[0], f.name),
                           getattr(t_new.modes[0], f.name), f.name)


@pytest.mark.parametrize("layout", ["blocked", "sorted"])
def test_apply_rebalance_skips_an_explicit_zero_value(layout):
    """A genuine entry stored as 0.0 is invisible to the ``vals != 0``
    padding convention: both packages skip its group ("stale-counts")
    rather than drop the entry."""
    t = skewed_tensor(explicit_zero=True)
    jp, tp, jm, tm = _migrate_both(t, layout)
    assert tm and int(tp.modes[0].nnz_true.sum()) == t.nnz
    j_new, j_applied = j_reb.apply_rebalance(jp, _decision(j_reb, jp, jm))
    t_new, t_applied = t_reb.apply_rebalance(tp, _decision(t_reb, tp, tm))
    assert t_applied == j_applied == [
        {"mode": 0, "group": 0, "moved_nnz": 0, "skipped": "stale-counts"}]
    _assert_same_plan(j_new, t_new)
    np.testing.assert_array_equal(t_new.modes[0].values, tp.modes[0].values)


# -- the probe ----------------------------------------------------------------

VARIANTS = {"ref": "blocked", "blocked": "blocked", "fused": "blocked",
            "sorted": "sorted"}


def _padded_factors(plan, rank, devices, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(plan.nmodes):
        f = rng.normal(size=(plan.modes[w].padded_rows, rank)).astype(
            np.float32)
        out.append([torch.from_numpy(f).to(d, copy=True) for d in devices])
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_probe_trims_each_shard(variant):
    """Each device's trimmed shard is a set of views of its placed shard
    (its first ``blocks_true`` blocks) whose ``sorted`` descriptors and
    visited tiles equal those recomputed from the trimmed rows alone; it
    gives the full shard's EC on every tile it visits and 0 elsewhere; the
    probe's times are positive, one per device, and neither the factors nor
    the placed shards change."""
    _, tp = _both_plans(skewed_tensor(), layout=VARIANTS[variant])
    mesh = t_dm.cp_mesh(4, 4, devices=["cpu"] * 4)
    factors = _padded_factors(tp, 8, mesh.devices)
    before = [[f.clone() for f in reps] for reps in factors]
    kw = t_ops.kernel_kwargs_from_config(
        tapi.KernelConfig(variant=variant, use_kernel=variant != "ref"))
    for mode, part in enumerate(tp.modes):
        full = t_dm.shard_plan_mode(part, mesh)
        placed = [[t.clone() for t in dataclasses.astuple(d)] for d in full]
        for dev in range(4):
            a = t_reb.trimmed_device_args(part, full[dev], dev)
            kb = max(int(part.blocks_true[dev]), 1)
            n = kb * part.block_p
            assert a["values"].shape == (n,)
            assert a["seg_starts"].shape[0] == kb
            d = full[dev]
            for name, t in (("indices", d.indices), ("values", d.values),
                            ("local_rows", d.local_rows),
                            ("block_to_tile", d.block_to_tile),
                            ("seg_starts", d.seg_starts),
                            ("seg_rows", d.seg_rows)):
                assert a[name].data_ptr() == t.data_ptr(), name
            rows = part.local_rows[dev, :n]
            ss, sr = t_part.block_segment_descriptors(
                rows, tile=part.tile, block_p=part.block_p)
            np.testing.assert_array_equal(a["seg_starts"].numpy(), ss)
            np.testing.assert_array_equal(a["seg_rows"].numpy(), sr)
            np.testing.assert_array_equal(a["local_rows"].numpy(), rows)
            visited = np.zeros(part.rows_max // part.tile, np.float32)
            visited[part.block_to_tile[dev, :kb]] = 1.0
            np.testing.assert_array_equal(a["tile_mask"].numpy(), visited)
            facs = [f[dev] for f in factors]
            geo = dict(mode=mode, num_rows=part.rows_max, tile=part.tile,
                       block_p=part.block_p, **kw)
            got = t_ops.mttkrp_local(factors=facs, **a, **geo)
            want = t_ops.mttkrp_local(
                d.indices, d.values, d.local_rows, d.block_to_tile, facs,
                tile_mask=d.tile_visited, seg_starts=d.seg_starts,
                seg_rows=d.seg_rows, **geo)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        times = t_reb.measure_mode_device_times(part, factors, kw,
                                                arrays=full, repeats=2)
        assert times.shape == (4,) and (times > 0).all()
        for d, old in zip(full, placed):
            assert all(torch.equal(x, y)
                       for x, y in zip(dataclasses.astuple(d), old))
    for reps, old in zip(factors, before):
        for x, y in zip(reps, old):
            assert torch.equal(x, y)


def test_reference_probe_has_no_sorted_descriptors():
    """The fault the port's probe does not copy: the reference's trimmed
    shard carries no segment descriptors, so its probe raises for
    ``sorted``."""
    jp, _ = _both_plans(skewed_tensor(), layout="sorted")
    rng = np.random.default_rng(0)
    factors = [jnp.asarray(rng.normal(size=(m.padded_rows, 8))
                           .astype(np.float32)) for m in jp.modes]
    with pytest.raises(ValueError, match="segment descriptors"):
        j_reb.measure_mode_device_times(
            jp.modes[0], factors, {"use_kernel": True, "variant": "sorted",
                                   "num_buffers": 2})


# -- the solver on 4 logical CPU devices -------------------------------------

def _solver_cfg(rebalance, **extra):
    return tapi.paper({"rank": 8, "runtime.tol": 0.0,
                       "runtime.num_devices": 4,
                       "partition.strategy": "equal_nnz",
                       "schedule.rebalance": rebalance,
                       "schedule.cadence": 1,
                       "schedule.imbalance_threshold": 1.1,
                       "schedule.migration_budget": 0.4, **extra})


@pytest.mark.parametrize("preset_overrides", [
    {}, {"kernel.variant": "sorted", "kernel.use_kernel": True,
         "partition.layout": "sorted"}], ids=["ref", "sorted"])
def test_measure_is_bitwise_off_on_four_cpu_devices(preset_overrides):
    t = skewed_tensor()
    runs = {}
    for mode in ("off", "measure"):
        cfg = _solver_cfg(mode, **preset_overrides)
        solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
        runs[mode] = (solver, solver.run(4))
    (s_off, r_off), (s_meas, r_meas) = runs["off"], runs["measure"]
    assert r_meas.fits == r_off.fits
    for a, b in zip(r_meas.factors, r_off.factors):
        np.testing.assert_array_equal(a, b)
    assert s_meas.plan.rebalance_epoch == 0
    assert [e["sweep"] for e in s_meas.schedule_events] == [1, 2, 3]
    assert all(e["migrations"] == 0 for e in s_meas.schedule_events)
    assert s_off.schedule_events == [] and \
        s_off.imbalance_report() == {"enabled": False, "events": []}
    rep = s_meas.imbalance_report()
    assert rep["enabled"] and rep["rebalance_epoch"] == 0
    assert set(rep["per_mode"]) == {0, 1, 2}
    timing = s_meas.rebalance_timings[-1]
    assert len(timing["probe_s"][0]) == 4 and timing["apply_s"] == 0.0
    # on CPU tensors the wrappers run their plain versions: no launch
    assert timing["probe_launches"] == {"ec_sorted": 0, "ec_fused": 0,
                                        "ec_blocked": 0}


def test_on_migrates_replaces_and_keeps_the_fit():
    """``"on"`` applies migrations on the hot-index tensor, re-places the
    moved modes (the placed shards are the new plan's arrays, and replicas
    stay bitwise equal) and fits as ``"off"`` does, to 1e-4."""
    t = skewed_tensor()
    cfg = _solver_cfg("on")
    plan = tapi.plan(t, cfg)
    s_on = tapi.compile(plan, cfg, device="cpu")
    r_on = s_on.run(5)
    r_off = tapi.compile(plan, _solver_cfg("off"), device="cpu").run(5)
    moved = sum(e["moved_nnz"] for e in s_on.schedule_events)
    assert moved > 0 and s_on.plan.rebalance_epoch >= 1
    np.testing.assert_allclose(r_on.fits, r_off.fits, atol=1e-4)
    for mode, part in enumerate(s_on.plan.modes):
        for k, dev in enumerate(s_on.dev_arrays[mode]):
            np.testing.assert_array_equal(dev.values.numpy(),
                                          part.values[k])
            np.testing.assert_array_equal(dev.local_rows.numpy(),
                                          part.local_rows[k])
    s = s_on.state
    for reps in s.factors + s.grams + [s.lam]:
        for x in reps[1:]:
            assert torch.equal(reps[0], x)
    timings = [x for x in s_on.rebalance_timings if x["moved_modes"]]
    assert timings and timings[0]["apply_s"] > 0


def test_memory_budget_with_rebalancer_is_unported(small_tensor):
    """Ported: with ``runtime.memory_budget`` set, the rebalancer's member
    caps are the store's streamed-slot budget per mode, the reference's
    values, and a migration never lifts a member above its cap."""
    import repro.api as japi
    from repro_torch.store import budget_slot_cap
    cfg = tapi.paper({"runtime.memory_budget": 1 << 20,
                      "schedule.rebalance": "measure"})
    plan = tapi.plan(t_coo.SparseTensor(small_tensor.indices, small_tensor.values,
                                         small_tensor.shape), cfg, device="cpu")
    with tapi.compile(plan, cfg, device="cpu") as solver:
        caps = solver.rebalancer.member_nnz_caps
    jcfg = japi.paper({"runtime.memory_budget": 1 << 20,
                       "schedule.rebalance": "measure"})
    jsolver = japi.compile(japi.plan(small_tensor, jcfg), jcfg)
    assert caps == jsolver.rebalancer.member_nnz_caps
    jsolver.close()
    for d, p in enumerate(plan.modes):
        assert caps[d] == budget_slot_cap(
            1 << 20, nmodes=3, n_tiles=p.rows_max // p.tile,
            block_p=p.block_p, buffers=2)
    jp, tp = _both_plans(skewed_tensor())
    times = np.array([1.0, 2.0, 2.0, 8.0])
    free = t_reb.plan_group_migrations(tp.modes[0], times,
                                       migration_budget=0.3)
    # a cap one block below the unclamped plan's largest member
    cap = max(max(m.nnz_target) for m in free) - tp.modes[0].block_p
    migs = t_reb.plan_group_migrations(tp.modes[0], times,
                                       migration_budget=0.3,
                                       max_member_nnz=cap)
    jmigs = j_reb.plan_group_migrations(jp.modes[0], times,
                                        migration_budget=0.3,
                                        max_member_nnz=cap)
    assert migs and [dataclasses.astuple(m) for m in migs] == \
        [dataclasses.astuple(m) for m in jmigs]
    for m in migs:
        assert max(m.nnz_target) <= cap


def test_launcher_rebalance_report(capsys):
    launcher.main(["--profile", "twitch", "--scale", "2e-5", "--iters", "4",
                   "--device", "cpu", "--devices", "4", "--set",
                   "partition.strategy=equal_nnz", "--rebalance"])
    out = capsys.readouterr().out
    assert "rebalance=on" in out
    assert "schedule: epoch " in out and "calibrated sec_per_nnz=" in out
    assert out.count("measured max/mean") == 5  # twitch has 5 modes
    for sweep in (1, 2, 3):  # cadence 2: one rebalance point, at sweep 2
        assert (f"  sweep {sweep}: worst imbalance" in out) == (sweep == 2)


def test_launcher_measure_balance(capsys):
    launcher.main(["--profile", "twitch", "--scale", "2e-5", "--iters", "3",
                   "--device", "cpu", "--devices", "4", "--set",
                   "schedule.cadence=1", "--measure-balance"])
    out = capsys.readouterr().out
    assert "rebalance=measure" in out and "schedule: epoch 0" in out
    assert "0 migration(s), 0 nnz moved" in out
