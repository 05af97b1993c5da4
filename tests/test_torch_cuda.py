"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the CPU, bitwise: the same f32 products, the same per-row order
of additions (slot order, and on a tile's run of more than ``CHUNK_BLOCKS``
blocks the fixed two-level order, which the plain versions follow too; on
the card their ``index_add_`` runs in slot order without the caller
setting any flag, ``ref.slot_order_index_add``). Also on the card: the
``ref`` EC's slot order end to end, the autotuner's cache key, and epoch
streaming against the resident run.

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
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
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
    (whose ``index_add_`` sums in slot order unasked), for every ring
    depth."""
    part, factors, mode, dev = LONG_RUN[case]()
    kw = dict(dev=dev, mode=mode, num_buffers=num_buffers)
    _assert_kernel_equals_plain(part, factors, variant, cuda, **kw)
    got = _ec(part, factors, variant, cuda, **kw)
    ref = _ec(part, factors, variant, cuda, plain=True, **kw)
    assert not torch.are_deterministic_algorithms_enabled()
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


# -- the ref EC in slot order, the autotuner, epoch streaming ----------------

def test_two_paper_runs_give_the_same_bits(cuda):
    """``ref`` (the paper preset's EC) sums in slot order on the card, so
    two runs give the same factors and fits, bitwise, with no flag set by
    the caller; a caller's deterministic-algorithms setting is left as it
    was."""
    t = skewed_tensor()
    cfg = api.preset("paper", {"rank": 8, "runtime.tol": 0.0,
                               "runtime.num_devices": 1})
    plan = api.plan(t, cfg)
    runs = [api.compile(plan, cfg).run(3) for _ in range(2)]
    assert not torch.are_deterministic_algorithms_enabled()
    assert runs[0].fits == runs[1].fits
    for a, b in zip(runs[0].factors, runs[1].factors):
        np.testing.assert_array_equal(a, b)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        api.compile(plan, cfg).run(1)
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


def test_ref_equals_sorted_on_short_runs(cuda):
    """On every tile whose run is at most CHUNK_BLOCKS blocks, ``ref`` and
    ``ec_sorted`` give the same bits on the card."""
    for seed in range(3):
        part, factors = partitioned_case(3, 16, seed=seed, nnz=1200)
        b2t = part.block_to_tile[0]
        starts = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
        got = _ec(part, factors, "sorted", cuda)
        ref = _ec(part, factors, "ref", cuda)
        short = [int(b2t[a]) for a, b in zip(starts[:-1], starts[1:])
                 if b - a <= _build.CHUNK_BLOCKS]
        assert short
        for tt in short:
            rows = slice(tt * part.tile, (tt + 1) * part.tile)
            assert torch.equal(got[rows], ref[rows])


def test_measure_is_bitwise_off_under_paper(cuda):
    """``schedule.rebalance="measure"`` under the paper preset (the ``ref``
    EC) on 4 logical devices of one card: factors and fits bitwise those
    of ``"off"``."""
    t = skewed_tensor()
    base = {"rank": 8, "runtime.tol": 0.0, "runtime.num_devices": 4,
            "partition.strategy": "equal_nnz", "partition.replication": None,
            "schedule.cadence": 1, "schedule.probe_repeats": 2}
    runs = {}
    for mode in ("off", "measure"):
        cfg = api.preset("paper", {**base, "schedule.rebalance": mode})
        with api.compile(api.plan(t, cfg), cfg, mesh=dm.cp_mesh(
                4, 4, devices=["cuda:0"] * 4)) as solver:
            runs[mode] = solver.run(4)
    assert runs["measure"].fits == runs["off"].fits
    for a, b in zip(runs["measure"].factors, runs["off"].factors):
        np.testing.assert_array_equal(a, b)


def test_tuner_writes_a_gpu_key_to_the_ports_cache_only(cuda, tmp_path,
                                                         monkeypatch):
    from repro_torch.kernels import autotune as t_at
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    ref.write_text('{"3m_r8_cpu_fused": {"tile": 8}}')
    before = ref.read_bytes()
    monkeypatch.setenv(t_at.ENV_CACHE, str(port))
    monkeypatch.setenv("AMPED_AUTOTUNE_CACHE", str(ref))
    monkeypatch.setattr(t_at, "_MEMO", {})
    launched = dict(_build.LAUNCHES)
    cfg = t_at.autotune_ec(3, 8, variant="sorted", nnz=1024, tiles=(8, 16),
                           block_ps=(64,), repeats=2)
    assert _build.LAUNCHES["ec_sorted"] - launched["ec_sorted"] == 4 * 3
    key = f"3m_r8_float32_gpu_{t_at.device_kind_tag()}_sorted"
    assert key.startswith("3m_r8_float32_gpu_nvidia-")
    import json
    entry = json.loads(port.read_text())[key]
    assert (entry["tile"], entry["block_p"], entry["num_buffers"]) == \
        (cfg.tile, cfg.block_p, cfg.num_buffers)
    assert len(entry["timings"]) == 4 and min(entry["timings"].values()) > 0
    assert ref.read_bytes() == before


def _stream_case(tmp_path, layout):
    from repro_torch.store import (TensorStore, build_plan_from_store,
                                   split_mode_super_shards,
                                   write_store_from_coo)
    t = random_sparse((400, 300, 200), 12000, seed=7, dedup=False)
    path = str(tmp_path / "w.store")
    write_store_from_coo(t, path, chunk_nnz=1024)
    plan = build_plan_from_store(TensorStore(path), 1, layout=layout)
    budget = 2 * max(p.nnz_max for p in plan.modes) * 21 // 3
    assert min(split_mode_super_shards(p, budget).num_shards
               for p in plan.modes) >= 2
    return plan, budget


@pytest.mark.parametrize("preset", ["paper", "sorted", "fused", "optimized"])
def test_streamed_equals_resident_on_card(cuda, tmp_path, preset):
    """A tensor-store plan streamed in super-shards through pinned buffers
    and a side stream: fits and factors bitwise those of the same plan run
    resident, and the window kernels were launched."""
    layout = "sorted" if preset == "sorted" else "blocked"
    plan, budget = _stream_case(tmp_path, layout)
    cfg = api.preset(preset, {"rank": 8, "runtime.tol": 0.0,
                              "kernel.autotune": False,
                              "partition.replication": 1})
    with api.compile(plan, cfg) as solver:
        resident = solver.run(3)
    scfg = cfg.with_overrides({"runtime.streaming": True,
                               "runtime.memory_budget": budget})
    _build.reset_launch_counts()
    with api.compile(plan, scfg) as solver:
        streamed = solver.run(3)
        report = solver.overlap_report()
        windows = sum(sp.num_shards for sp in solver.stream_plans)
    assert streamed.fits == resident.fits
    for a, b in zip(streamed.factors, resident.factors):
        np.testing.assert_array_equal(a, b)
    if preset != "paper":
        name = {"optimized": "ec_blocked"}.get(preset, f"ec_{preset}")
        assert _build.LAUNCHES[name] == 3 * windows
    assert report["peak_resident_bytes"] <= budget


@pytest.mark.parametrize("variant", ["ref", "sorted", "fused", "blocked"])
def test_window_pads_splitting_a_run_on_card(cuda, tmp_path, variant):
    """A window whose 30 trailing pad blocks turn its last tile's 10-block
    run into a 40-block one, split into work items: the accumulated
    partial is the resident partial, bitwise, on the card."""
    from repro_torch.store import (TensorStore, budget_slot_cap,
                                   build_plan_from_store,
                                   split_mode_super_shards,
                                   write_store_from_coo)
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.integers(0, 8, 640), rng.integers(8, 16, 160)])
    ind = np.stack([rows, rng.integers(0, 64, 800), rng.integers(0, 48, 800)],
                   axis=1).astype(np.int32)
    from repro_torch.core.coo import SparseTensor
    path = str(tmp_path / "pads.store")
    write_store_from_coo(SparseTensor(
        ind, rng.standard_normal(800).astype(np.float32), (16, 64, 48)),
        path, chunk_nnz=64)
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
    mesh = dm.cp_mesh(1, 1, devices=[cuda])
    f = [[torch.from_numpy(rng.normal(size=(p.padded_rows, 8)).astype(
        np.float32)).to(cuda)] for p in plan.modes]
    kw = dict(use_kernel=variant != "ref", variant=variant)
    want = dm.make_mttkrp_fn(part, mesh, **kw).local(
        dm.shard_plan_mode(part, mesh), f)[0]
    acc = dm.zero_partials(part, mesh, 8)
    pfn = dm.make_partial_mttkrp_fn(part, mesh, **kw)
    streams = {cuda.index or 0: torch.cuda.Stream(device=cuda)}
    for k in range(sp.num_shards):
        placed = dm.shard_super_shard(part, sp, k, mesh, streams=streams)
        acc = pfn(acc, placed.wait(), f)
    assert torch.equal(acc[0], want)


# -- the tracer, checkpoints and the BLCO-style baseline on the card ---------

@pytest.mark.parametrize("preset", ["sorted", "paper"])
def test_traced_sweep_is_bitwise_the_untraced_one_on_card(cuda, preset):
    """The traced split (EC into a zero accumulator, then the finish, each
    followed by a synchronise) gives the untraced sweep's bits on the card,
    on a tile whose run is longer than CHUNK_BLOCKS blocks."""
    from repro_torch import obs
    from repro_torch.core.coo import SparseTensor
    rng = np.random.default_rng(4)
    ind = np.stack([rng.integers(0, s, 730) for s in (20, 12, 10)], axis=1)
    ind[:640, 1] = 2
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=730).astype(np.float32), (20, 12, 10))
    over = {"rank": 8, "kernel.autotune": False, "runtime.tol": 0.0,
            "runtime.num_devices": 1, "partition.tile": 8,
            "partition.block_p": 16}
    cfg = api.preset(preset, over)
    plan = api.plan(t, cfg)
    with api.compile(plan, cfg) as solver:
        plain = solver.run(3)
    obs.reset()
    try:
        tcfg = cfg.with_overrides({"runtime.trace": True})
        with api.compile(plan, tcfg) as solver:
            traced = solver.run(3)
        counts = obs.export.span_counts(obs.trace.get_tracer().records())
    finally:
        obs.reset()
    assert traced.fits == plain.fits
    for a, b in zip(traced.factors, plain.factors):
        np.testing.assert_array_equal(a, b)
    assert counts["ec"] == counts["exchange"] == 9 and counts["sweep"] == 3


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Checkpoints of a solver on the card hold its host bits; a fresh
    solver restored at sweep 2 runs to 4 within 1e-6 (fits) and 1e-5
    (factors) of the uninterrupted run."""
    t = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    cfg = api.preset("sorted", {
        "rank": 8, "kernel.autotune": False, "runtime.tol": 0.0,
        "runtime.num_devices": 1,
        "runtime.checkpoint_dir": str(tmp_path)})
    plan = api.plan(t, cfg)
    with api.compile(plan, cfg) as solver:
        full = solver.run(4)
        saved = solver._ckpt_mgr.restore(4)
    for a, b in zip(saved["factors"], full.factors):
        np.testing.assert_array_equal(a, b)
    with api.compile(plan, cfg) as solver:
        assert solver.restore(2)
        assert solver.state.factors[0][0].device.type == "cuda"
        resumed = solver.run(4)
    np.testing.assert_allclose(resumed.fits, full.fits, atol=1e-6)
    for a, b in zip(resumed.factors, full.factors):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_blco_baseline_on_card_matches_cpu(cuda, mode):
    """The baseline on the card against its CPU run within 1e-5 (the
    card's deterministic index_add_ adds in slot order; the gathers and
    products are the same f32 operations), with CUDA-event EC times."""
    from repro_torch.core.baselines import blco_like_streaming
    t = random_sparse((400, 300, 200), 20000, seed=3, distribution="zipf")
    rng = np.random.default_rng(0)
    factors = [torch.from_numpy(rng.normal(size=(s, 16)).astype(np.float32))
               for s in t.shape]
    got, times = blco_like_streaming(t, factors, mode, chunk=4096)
    want, cpu_times = blco_like_streaming(t, factors, mode, chunk=4096,
                                          device="cpu")
    assert got.device.type == "cuda"
    assert times["chunks"] == cpu_times["chunks"] == -(-t.nnz // 4096) > 1
    assert times["ec_s"] > 0 and times["h2d_s"] > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_placed_wait_marks_the_shards_and_copies_nothing(cuda):
    """``Placed.wait`` on shards copied on a side stream: no device memory
    is allocated (it deep-copied every tensor before), and the current
    stream waits for the copy."""
    t = random_sparse((400, 300, 200), 20000, seed=3, distribution="zipf")
    plan = build_plan(t, 1)
    mesh = dm.cp_mesh(1, 1, devices=[cuda])
    placed = dm.place_mode(plan.modes[0], mesh,
                           streams={cuda.index or 0:
                                    torch.cuda.Stream(device=cuda)})
    assert placed.ready[0] is not None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    arrays = placed.wait()
    assert torch.cuda.max_memory_allocated(cuda) == before
    assert arrays[0].values.data_ptr() == placed.arrays[0].values.data_ptr()


# -- serving and the audit on the card ----------------------------------------

def test_slot_order_index_add_is_the_deterministic_index_add(cuda):
    """``ref.slot_order_index_add`` on the card gives the bits of
    ``index_add_`` under ``torch.use_deterministic_algorithms(True)``, and
    leaves that switch off, so an operation on another thread is not
    changed by it (a cuBLAS product would raise under it). Into a zero
    output, as every caller adds, it gives the CPU's slot-order bits (into
    a nonzero one the card adds each row's sum of terms to it)."""
    from repro_torch.kernels.ref import slot_order_index_add
    rng = np.random.default_rng(0)
    index = torch.from_numpy(rng.integers(0, 50, 20000)).to(cuda)
    src = torch.from_numpy(rng.standard_normal((20000, 32)).astype(
        np.float32)).to(cuda)
    base = torch.from_numpy(rng.standard_normal((50, 32)).astype(
        np.float32)).to(cuda)
    got = slot_order_index_add(base.clone(), index, src)
    assert not torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        want = base.clone().index_add_(0, index, src)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    zero = torch.zeros_like(base)
    cpu = slot_order_index_add(zero.cpu(), index.cpu(), src.cpu())
    torch.testing.assert_close(
        slot_order_index_add(zero, index, src).cpu(), cpu, rtol=0, atol=0)


SERVE_RANK, SERVE_SHAPE = 4, (48, 40, 32)


def _serve_setup(tmp_path):
    """A base store of an exactly low-rank tensor, a 10-sweep fit on the
    card with checkpoints, and the appended rest (tests/test_serve.py's
    fixture)."""
    from repro_torch.sparse.io import make_lowrank_tensor
    from repro_torch.store import TensorStore, write_store_from_coo
    t = make_lowrank_tensor(SERVE_SHAPE, SERVE_RANK, 3000, seed=0)
    base_n = int(t.nnz * 0.85)
    path = str(tmp_path / "grow.store")
    write_store_from_coo(SparseTensor(t.indices[:base_n], t.values[:base_n],
                                      t.shape), path, chunk_nnz=512)
    ckpt = str(tmp_path / "ckpts")
    cfg = api.DecomposeConfig(rank=SERVE_RANK, runtime=api.RuntimeConfig(
        num_devices=1, tol=0.0, seed=0))
    with api.compile(api.plan(TensorStore(path), cfg), cfg.with_overrides(
            {"runtime.checkpoint_dir": ckpt})) as solver:
        result = solver.run(10)
    return t, base_n, path, ckpt, cfg, result


def test_serving_engine_parity_on_the_card(cuda, tmp_path):
    from repro_torch.serve import FactorSnapshot, ServingEngine
    *_, result = _serve_setup(tmp_path)
    engine = ServingEngine(FactorSnapshot.from_result(result))
    assert engine.snapshot.device.type == "cuda"
    rng = np.random.default_rng(1)
    for n in (1, 7, 9, 100, 257):
        coords = np.stack([rng.integers(0, s, size=n) for s in SERVE_SHAPE],
                          axis=1)
        np.testing.assert_allclose(engine.reconstruct_batch(coords),
                                   result.reconstruct_at(coords),
                                   rtol=1e-4, atol=1e-5)
    scores, idx = engine.topk_slice(np.array([3, 0, 5]), mode=1, k=5)
    dense = result.reconstruct_at(np.stack(
        [np.full(SERVE_SHAPE[1], 3), np.arange(SERVE_SHAPE[1]),
         np.full(SERVE_SHAPE[1], 5)], axis=1))
    np.testing.assert_allclose(scores, np.sort(dense)[::-1][:5],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dense[idx], scores, rtol=1e-4, atol=1e-5)


def test_concurrent_queries_during_background_refit_on_the_card(cuda,
                                                                tmp_path):
    """The ``ref`` refit (the default config) runs on a background thread
    while this thread queries through the batcher and the top-k path:
    every answer is bitwise v1's or v2's, and no query raises (the refit's
    slot-order sums set no process-wide switch)."""
    from repro_torch.serve import CPService
    from repro_torch.store import TensorStore, append_to_store
    t, base_n, path, ckpt, cfg, _ = _serve_setup(tmp_path)
    rng = np.random.default_rng(5)
    coords = np.stack([rng.integers(0, s, size=64) for s in SERVE_SHAPE],
                      axis=1)
    with CPService.boot(ckpt, store=TensorStore(path), config=cfg) as svc:
        want_v1 = svc.reconstruct(coords)
        top_v1 = svc.topk(coords[0], mode=1, k=5)
        append_to_store(path, t.indices[base_n:].astype(np.int64),
                        t.values[base_n:])
        assert svc.refresh(sweeps=4, wait=False)["background"]
        answers, tops = [], []
        while True:  # the last query starts after the publish
            running = svc.metrics.gauge("refit_in_progress", 0) == 1
            answers.append(svc.reconstruct(coords))
            tops.append(svc.topk(coords[0], mode=1, k=5))
            if not running:
                break
        done = svc.wait_refresh()
        assert done["published"] and svc.engine.version == 2
        want_v2 = svc.reconstruct(coords)
        top_v2 = svc.topk(coords[0], mode=1, k=5)
    assert not np.array_equal(want_v1, want_v2)
    for a in answers:
        assert np.array_equal(a, want_v1) or np.array_equal(a, want_v2)
    for s, _ in tops:
        assert np.array_equal(s, top_v1[0]) or np.array_equal(s, top_v2[0])
    # queries overlapped the refit (v1 answers after refresh() returned)
    # and the one begun after the publish answered as v2
    assert np.array_equal(answers[0], want_v1)
    assert np.array_equal(answers[-1], want_v2)
    assert np.array_equal(tops[-1][0], top_v2[0])


def test_audit_on_the_card_names_the_eigh_sync(cuda):
    """On the card the audit reports the host synchronisation of
    ``_pinv_psd``'s ``torch.linalg.eigh`` under AH-H002 in every mode's
    update and nothing else, and the solver's state stays bitwise as it
    was."""
    t = skewed_tensor()
    cfg = api.preset("sorted", {"rank": 16, "kernel.autotune": False,
                                "partition.tile": 8,
                                "partition.block_p": 64,
                                "runtime.num_devices": 1})
    with api.compile(api.plan(t, cfg), cfg) as solver:
        solver.run(2)
        before = [[f.clone() for f in reps] for reps in solver.state.factors]
        lam = solver.state.lam[0].clone()
        launched = _build.LAUNCHES["ec_sorted"]
        findings = solver.audit()
        assert _build.LAUNCHES["ec_sorted"] > launched  # the kernel ran
        assert torch.cuda.get_sync_debug_mode() == 0
        for reps, want in zip(solver.state.factors, before):
            for f, g in zip(reps, want):
                assert torch.equal(f, g)
        assert torch.equal(solver.state.lam[0], lam)
    assert {f.rule for f in findings} == {"AH-H002"}, findings
    assert sorted(f.location for f in findings) == [
        f"mode={d} update" for d in range(3)], findings
    assert all("_pinv_psd" in f.message and "core/als.py" in f.message
               for f in findings), findings
