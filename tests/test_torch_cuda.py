"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the CPU, bitwise: the same f32 products, the same per-row order
of additions (slot order, and on a tile's run of more than ``CHUNK_BLOCKS``
blocks the fixed two-level order, which the plain versions follow too; on
the card they do so under ``torch.use_deterministic_algorithms(True)``).

Marked ``gpu``: skipped where no card is present, which the fixture below
decides at run time. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cases import (BLOCKED_PROPERTY, BLOCKED_SHAPES,  # noqa: E402
                          DEGENERATE_SORTED, LONG_RUN, blocked_case,
                          partitioned_case, shard_arrays, skewed_tensor)
import repro_torch.api as api  # noqa: E402
from repro_torch.comm import ExchangeSpec  # noqa: E402
from repro_torch.core import mttkrp as dm  # noqa: E402
from repro_torch.core.partition import build_plan  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.mttkrp_blocked import (RING_DEPTH,  # noqa: E402
                                                ec_blocked)
from repro_torch.schedule import rebalance  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ec(part, factors, variant, device, dev=0, mode=1, num_buffers=2,
        plain=False):
    """One shard's EC through ``mttkrp_local`` (``plain``: the variant's
    plain version on the same device, through ``kernel_args``)."""
    a = shard_arrays(part, dev)
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    facs = [torch.from_numpy(f).to(device) for f in factors]
    if plain:
        from repro_torch.kernels import (mttkrp_blocked, mttkrp_fused,
                                         mttkrp_sorted)
        fn = {"sorted": mttkrp_sorted.ec_sorted_plain,
              "fused": mttkrp_fused.ec_fused_plain,
              "blocked": mttkrp_blocked.ec_blocked_plain}[variant]
        args = ops.kernel_args(variant, t["indices"], t["values"],
                               t["local_rows"], t["block_to_tile"], facs,
                               mode=mode, tile=part.tile,
                               seg_starts=t["seg_starts"],
                               seg_rows=t["seg_rows"])
        out = fn(*args, num_rows=part.rows_max, tile=part.tile,
                 block_p=part.block_p)
        return ops._mask_unvisited(out, t["tile_visited"], part.tile).cpu()
    return ops.mttkrp_local(
        t["indices"], t["values"], t["local_rows"], t["block_to_tile"], facs,
        mode=mode, num_rows=part.rows_max, tile=part.tile,
        block_p=part.block_p, variant=variant, num_buffers=num_buffers,
        tile_mask=t["tile_visited"], seg_starts=t["seg_starts"],
        seg_rows=t["seg_rows"]).cpu()


def _assert_kernel_equals_plain(part, factors, variant, cuda, **kw):
    before = _build.LAUNCHES[f"ec_{variant}"]
    got = _ec(part, factors, variant, cuda, **kw)
    assert _build.LAUNCHES[f"ec_{variant}"] == before + 1
    ref = _ec(part, factors, variant, "cpu", **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [8, 32])
def test_kernel_matches_plain(cuda, variant, nmodes, rank):
    layout = "sorted" if variant == "sorted" else "blocked"
    part, factors = partitioned_case(nmodes, rank, seed=nmodes * 10 + rank,
                                     layout=layout)
    _assert_kernel_equals_plain(part, factors, variant, cuda)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("num_buffers", [2, 3, 4])
def test_kernel_num_buffers(cuda, variant, num_buffers):
    part, factors = partitioned_case(3, 16, seed=5)
    _assert_kernel_equals_plain(part, factors, variant, cuda,
                                num_buffers=num_buffers)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("case", sorted(DEGENERATE_SORTED))
def test_kernel_degenerate_shards(cuda, variant, case):
    part, factors, mode, dev = DEGENERATE_SORTED[case]()
    _assert_kernel_equals_plain(part, factors, variant, cuda, dev=dev,
                                mode=mode)


# blocked runs at its wrapper's fixed ring depth
@pytest.mark.parametrize("variant,num_buffers", [
    ("sorted", 2), ("sorted", 3), ("sorted", 4), ("fused", 2), ("fused", 3),
    ("fused", 4), ("blocked", RING_DEPTH)])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_kernel_long_runs(cuda, case, variant, num_buffers):
    """Runs of more than CHUNK_BLOCKS blocks, split into work items and
    combined: bitwise equal to the plain version on the CPU and on the card
    (deterministic, index-order ``index_add_``), for every ring depth."""
    part, factors, mode, dev = LONG_RUN[case]()
    kw = dict(dev=dev, mode=mode, num_buffers=num_buffers)
    _assert_kernel_equals_plain(part, factors, variant, cuda, **kw)
    got = _ec(part, factors, variant, cuda, **kw)
    torch.use_deterministic_algorithms(True)
    try:
        ref = _ec(part, factors, variant, cuda, plain=True, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_kernel_two_launches_same_bits(cuda, variant):
    part, factors, mode, dev = LONG_RUN["hot_row_4mode"]()
    a = _ec(part, factors, variant, cuda, dev=dev, mode=mode)
    b = _ec(part, factors, variant, cuda, dev=dev, mode=mode)
    assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("nmodes,rank,num_buffers", [
    (2, 4, 2), (3, 6, 3), (4, 64, 4), (5, 64, 4), (5, 128, 2)])
def test_smem_model_is_what_the_kernel_lays_out(cuda, variant, nmodes, rank,
                                                num_buffers):
    """The C entry point refuses a launch whose shared memory differs from
    its own layout, so a launch at the modelled bytes that runs and matches
    the plain version shows the model exact; a rank not a multiple of 4
    takes the 4-byte copies. (``blocked`` runs at its fixed ring depth.)"""
    part, factors = partitioned_case(nmodes, rank, seed=rank + nmodes)
    _assert_kernel_equals_plain(part, factors, variant, cuda,
                                num_buffers=num_buffers)


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_oversized_item_kernel_raises_before_launch(cuda, variant):
    # blocked's ring is 2 stages deep, so it needs a larger tile to overflow
    tile = 64 if variant == "blocked" else 32
    part, factors = partitioned_case(5, 128, seed=3, tile=tile)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        _ec(part, factors, variant, cuda, num_buffers=4)
    assert _build.LAUNCHES == before


def test_item_launch_rejects_a_wrong_smem_size(cuda, monkeypatch):
    """Called with other bytes than its layout needs, the C entry point
    returns an error instead of launching."""
    from repro_torch.kernels import mttkrp_fused
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f).to(cuda) for f in factors]
    args = ops.kernel_args("fused", a["indices"], a["values"],
                           a["local_rows"], a["block_to_tile"], facs, mode=1,
                           tile=part.tile)
    real = _build.variant_smem_bytes
    monkeypatch.setattr(_build, "variant_smem_bytes",
                        lambda *x, **k: real(*x, **k) + 16)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        mttkrp_fused.ec_fused(*args, num_rows=part.rows_max, tile=part.tile,
                              block_p=part.block_p)


def test_blocked_launch_rejects_a_wrong_smem_size(cuda, monkeypatch):
    """The same refusal at ec_blocked's C entry point."""
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f).to(cuda) for f in factors]
    args = ops.kernel_args("blocked", a["indices"], a["values"],
                           a["local_rows"], a["block_to_tile"], facs, mode=1,
                           tile=part.tile)
    real = _build.variant_smem_bytes
    monkeypatch.setattr(_build, "variant_smem_bytes",
                        lambda *x, **k: real(*x, **k) + 16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        ec_blocked(*args, num_rows=part.rows_max, tile=part.tile,
                   block_p=part.block_p)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_kernel_replicated_shards(cuda, variant):
    part, factors = partitioned_case(3, 16, seed=3, num_devices=2,
                                     replication=2)
    for dev in range(2):
        _assert_kernel_equals_plain(part, factors, variant, cuda, dev=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_ec_blocked_direct(cuda, shape, dtype):
    tile, p, r, nin = shape
    b2t, rit, vals, gathered = blocked_case(7, tile, 5, p, r, nin, seed=1)
    args = [torch.from_numpy(x) for x in (vals, rit, b2t)]
    rows = [torch.from_numpy(g).to(dtype) for g in gathered]
    kw = dict(num_rows=5 * tile, tile=tile, block_p=p)
    got = ec_blocked(*[a.to(cuda) for a in args],
                     [g.to(cuda) for g in rows], **kw).cpu()
    ref = ec_blocked(*args, rows, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("seed,nblocks,n_tiles", BLOCKED_PROPERTY)
def test_ec_blocked_property(cuda, seed, nblocks, n_tiles):
    b2t, rit, vals, gathered = blocked_case(nblocks, 8, n_tiles, 16, 8, 2,
                                            seed)
    args = [torch.from_numpy(x) for x in (vals, rit, b2t)]
    rows = [torch.from_numpy(g) for g in gathered]
    kw = dict(num_rows=n_tiles * 8, tile=8, block_p=16)
    got = ec_blocked(*[a.to(cuda) for a in args],
                     [g.to(cuda) for g in rows], **kw).cpu()
    torch.testing.assert_close(got, ec_blocked(*args, rows, **kw),
                               rtol=0, atol=0)


def test_tile_runs_on_card(cuda):
    b2t = np.array([0, 0, 3, 3, 3, 4, 7, 7], np.int32)
    got = _build.tile_runs(torch.from_numpy(b2t).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, [0, 2, 5, 6, 8, 8, 8, 8, 8])


def test_kernel_rejects_bad_arguments(cuda):
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v).to(cuda)
         for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f).to(cuda) for f in factors]
    kw = dict(mode=1, num_rows=part.rows_max, tile=part.tile,
              block_p=part.block_p, variant="fused",
              tile_mask=a["tile_visited"])
    with pytest.raises(TypeError):
        ops.mttkrp_local(a["indices"], a["values"].double(), a["local_rows"],
                         a["block_to_tile"], facs, **kw)
    with pytest.raises(ValueError):
        ops.mttkrp_local(a["indices"], a["values"], a["local_rows"],
                         a["block_to_tile"].cpu(), facs, **kw)


@pytest.mark.parametrize("preset", ["paper", "optimized", "fused", "sorted"])
def test_als_on_card_matches_cpu(cuda, preset):
    """Ten sweeps on the card and on the CPU from the same seed: fits agree
    to 1e-4 (the card's grams and solve sum in another order)."""
    t = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    cfg = api.preset(preset, {"rank": 8, "kernel.autotune": False,
                              "runtime.tol": 0.0, "runtime.num_devices": 1})
    plan = api.plan(t, cfg)
    fits = {d: api.compile(plan, cfg, device=d).run(10).fits
            for d in (cuda, "cpu")}
    np.testing.assert_allclose(fits[cuda], fits["cpu"], atol=1e-4)


def test_sorted_als_on_card_counts_launches(cuda):
    t = random_sparse((16, 12, 10), 300, seed=2, distribution="zipf")
    cfg = api.preset("sorted", {"rank": 4, "kernel.autotune": False,
                                "runtime.tol": 0.0, "runtime.num_devices": 1})
    solver = api.compile(api.plan(t, cfg), cfg)
    _build.reset_launch_counts()
    solver.run(3)
    assert _build.LAUNCHES == {"ec_sorted": 9, "ec_fused": 0, "ec_blocked": 0}


# -- 4 logical devices: the EC under each shard's device, merge, gather ------

CARDS = {"cuda:0": ["cuda:0"] * 4, "cuda:1": ["cuda:1"] * 4,
         "two cards": ["cuda:0", "cuda:1"] * 2}


def _mesh_devices(cuda, cards):
    devices = CARDS[cards]
    needed = max(torch.device(d).index for d in devices) + 1
    if torch.cuda.device_count() < needed:
        pytest.skip(f"needs {needed} cards")
    return devices


@pytest.mark.parametrize("spec", [
    ExchangeSpec(variant="ring", merge="psum_scatter"),
    ExchangeSpec(variant="overlap", merge="ring_rs", chunk_rows=4,
                 wire_dtype="bfloat16")], ids=["ring-f32", "overlap-bf16"])
@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("cards", list(CARDS))
def test_four_device_mttkrp_on_card_matches_cpu(cuda, cards, variant, spec):
    """The 4-logical-device MTTKRP (r = 2) on the card against the same on
    4 logical CPU devices, bitwise: the kernels equal their plain versions
    bitwise, and the merge and the gather add and copy the same values in
    the same order. Each shard's kernel launches on its own device."""
    devices = _mesh_devices(cuda, cards)
    t = random_sparse((40, 30, 20), 1500, seed=7, distribution="zipf")
    plan = build_plan(t, 4, replication=2,
                      layout="sorted" if variant == "sorted" else "blocked")
    rng = np.random.default_rng(0)
    glob = [rng.normal(size=(s, 8)).astype(np.float32) for s in t.shape]
    outs = {}
    for where in ("card", "cpu"):
        mesh = dm.cp_mesh(4, 2, devices=devices if where == "card"
                          else ["cpu"] * 4)
        factors = []
        for w, g in enumerate(glob):
            f = np.zeros((plan.modes[w].padded_rows, 8), np.float32)
            f[plan.global_to_padded[w]] = g
            factors.append([torch.from_numpy(f).to(d) for d in mesh.devices])
        before = _build.LAUNCHES[f"ec_{variant}"]
        outs[where] = [dm.distributed_mttkrp(
            plan, mode, mesh, dm.shard_plan_mode(plan.modes[mode], mesh),
            factors, variant=variant, exchange_spec=spec)
            for mode in range(3)]
        if where == "card":
            assert _build.LAUNCHES[f"ec_{variant}"] == before + 12
            for mode_out in outs[where]:
                assert [o.device for o in mode_out] == list(mesh.devices)
    for card_out, cpu_out in zip(outs["card"], outs["cpu"]):
        for a, b in zip(card_out, cpu_out):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)


@pytest.mark.parametrize("cards", list(CARDS))
def test_four_device_als_on_card(cuda, cards):
    """Ten sweeps on 4 logical devices on the card: every replica holds the
    same bits, the fits agree with 4 logical CPU devices to 1e-4 (the
    card's grams and solve sum in another order), and ec_sorted launched
    once per device, mode and sweep."""
    devices = _mesh_devices(cuda, cards)
    t = random_sparse((40, 30, 20), 1500, seed=7, distribution="zipf")
    cfg = api.preset("sorted", {"rank": 8, "kernel.autotune": False,
                                "runtime.tol": 0.0, "runtime.num_devices": 4,
                                "partition.replication": 2})
    plan = api.plan(t, cfg)
    solver = api.compile(plan, cfg, mesh=dm.cp_mesh(4, 2, devices=devices))
    _build.reset_launch_counts()
    res = solver.run(10)
    assert _build.LAUNCHES["ec_sorted"] == 3 * 4 * 10
    s = solver.state
    for reps in s.factors + s.grams + [s.lam, s.replica_fits]:
        for x in reps[1:]:
            assert torch.equal(reps[0].cpu(), x.cpu())
    cpu = api.compile(plan, cfg, device="cpu").run(10)
    np.testing.assert_allclose(res.fits, cpu.fits, atol=1e-4)


# -- the rebalancer: probes, migrated shards, measure-only runs ---------------

LAYOUT = {"sorted": "sorted", "fused": "blocked", "blocked": "blocked"}


def _card_factors(plan, devices, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for m in plan.modes:
        f = rng.normal(size=(m.padded_rows, rank)).astype(np.float32)
        out.append([torch.from_numpy(f).to(d, copy=True) for d in devices])
    return out


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_probe_times_each_kernel_with_cuda_events(cuda, variant):
    """The probe launches the variant's kernel once to warm up and then
    ``repeats`` times per logical device, timed with CUDA events: 4 devices
    of one card, best of 2, positive times."""
    plan = build_plan(skewed_tensor(), 4, strategy="equal_nnz",
                      layout=LAYOUT[variant])
    mesh = dm.cp_mesh(4, 4, devices=["cuda:0"] * 4)
    factors = _card_factors(plan, mesh.devices)
    name = f"ec_{variant}"
    for part in plan.modes:
        arrays = dm.shard_plan_mode(part, mesh)
        before = _build.LAUNCHES[name]
        times = rebalance.measure_mode_device_times(
            part, factors, dict(use_kernel=True, variant=variant,
                                num_buffers=2), arrays=arrays, repeats=2)
        assert _build.LAUNCHES[name] == before + 4 * (1 + 2)
        assert times.shape == (4,) and np.isfinite(times).all()
        assert (times > 0).all()


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_migrated_shards_on_card_give_plain_bits(cuda, variant):
    """An applied migration, re-placed on cuda:0 by shard_plan_mode: every
    moved shard's kernel equals the plain version on the CPU bitwise."""
    plan = build_plan(skewed_tensor(), 4, strategy="equal_nnz",
                      layout=LAYOUT[variant])
    migs = rebalance.plan_group_migrations(
        plan.modes[0], np.array([1.0, 2.0, 2.0, 8.0]), migration_budget=0.3)
    new, applied = rebalance.apply_rebalance(plan, rebalance.ReplanDecision(
        epoch=0, sweep=1, triggered=True, imbalance={},
        modelled_imbalance={}, migrations=tuple(migs)))
    assert sum(a["moved_nnz"] for a in applied) > 0
    part = new.modes[0]
    outs = {}
    for where in ("card", "cpu"):
        mesh = dm.cp_mesh(4, 4, devices=["cuda:0" if where == "card"
                                         else "cpu"] * 4)
        factors = _card_factors(new, mesh.devices)
        outs[where] = dm.make_mttkrp_fn(part, mesh, variant=variant).local(
            dm.shard_plan_mode(part, mesh), factors)
    for got, want in zip(outs["card"], outs["cpu"], strict=True):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_measure_is_bitwise_off_on_one_card(cuda):
    """``schedule.rebalance="measure"`` on 4 logical devices of one card:
    factors and fits bitwise those of ``"off"``, and ec_sorted launched
    once per mode, device and sweep plus the probes' launches, which the
    solver counts at each rebalance point."""
    t = skewed_tensor()
    base = {"rank": 8, "kernel.autotune": False, "runtime.tol": 0.0,
            "runtime.num_devices": 4, "partition.strategy": "equal_nnz",
            "schedule.cadence": 1, "schedule.probe_repeats": 2}
    runs = {}
    for mode in ("off", "measure"):
        cfg = api.preset("sorted", {**base, "schedule.rebalance": mode})
        solver = api.compile(api.plan(t, cfg), cfg, mesh=dm.cp_mesh(
            4, 4, devices=["cuda:0"] * 4))
        _build.reset_launch_counts()
        runs[mode] = solver.run(4)
        launches = _build.LAUNCHES["ec_sorted"]
    assert runs["measure"].fits == runs["off"].fits
    for a, b in zip(runs["measure"].factors, runs["off"].factors):
        np.testing.assert_array_equal(a, b)
    assert launches == 4 * 3 * 4 + 3 * (3 * 4 * (1 + 2))
    assert len(solver.schedule_events) == 3
    for tm in solver.rebalance_timings:
        assert tm["probe_launches"] == {"ec_sorted": 3 * 4 * (1 + 2),
                                        "ec_fused": 0, "ec_blocked": 0}
