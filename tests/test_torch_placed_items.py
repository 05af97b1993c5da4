"""The EC's work items placed with each shard, on the CPU.

A placed shard carries its work items (``DeviceArrays.items``): the
``(item_starts, item_part, split)`` of ``_build.tile_chunks`` on its
``block_to_tile``, packed in one int32 tensor (``_build.pack_items``) and
computed once at placement (``core.mttkrp.place_shard``), and every EC
launch is given them. Held here: the placed items are bitwise
``tile_chunks`` of the placed ``block_to_tile`` on resident shards (the
split-run and pad-slot cases, the benchmark configurations' ``tests``
cuts), on streamed windows with and without the window spill, and on the
modes re-placed after a rebalance migration; a sweep, the rebalancer's
probe, the tuner and the audit count one ``ec.items.placed`` a launch; a
launch without items is refused. And with no mask after the EC, every
output row outside the tiles a shard's blocks visit is +0.0, a NaN in
each input factor's row 0 (the pads' row) notwithstanding, on every shard
producer and every variant. Also what ``ec_sorted``'s kernel makes of the
placed items: the lane-group positions of the steps it walks each item in
(``_build.step_slots``), against a count item by item, and the gauge
``ec.step_fill_share.mode<d>`` ``api.compile`` sets from them.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cases import LONG_RUN, PAD_STAGES, skewed_tensor  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.analysis import hlo_audit  # noqa: E402
from repro_torch.core import als  # noqa: E402
from repro_torch.core import mttkrp as dm  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.core.partition import build_plan  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.schedule import rebalance as reb  # noqa: E402
from repro_torch.sparse import stream as st  # noqa: E402
from repro_torch.store import (TensorStore, build_plan_from_store,  # noqa: E402
                               split_mode_super_shards, write_store_from_coo)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["amazon-r32", "twitch-r32", "patents-r32"]
VARIANTS = ["sorted", "fused", "blocked", "ref"]


def _counts():
    return obs.get_registry().counter("ec.items.placed")


def _assert_placed_items(dev):
    """``dev.items`` is bitwise ``tile_chunks`` of ``dev.block_to_tile``,
    packed, and its views are that ``TileChunks``."""
    b2t = dev.block_to_tile
    want = _build.tile_chunks(b2t)
    assert dev.items.dtype == torch.int32 and dev.items.is_contiguous()
    assert dev.items.numel() == _build.item_words(b2t.numel())
    assert torch.equal(dev.items, _build.pack_items(b2t))
    got = _build.item_views(dev.items, b2t.numel())
    for a, b in zip(got[:3], want[:3], strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    assert got.n_parts == want.n_parts


def _mesh(part):
    return dm.cp_mesh(part.num_devices, part.r,
                      devices=["cpu"] * part.num_devices)


@pytest.mark.parametrize("case", sorted(LONG_RUN) + sorted(PAD_STAGES))
def test_resident_items_are_tile_chunks(case):
    part, *_ = {**LONG_RUN, **PAD_STAGES}[case]()
    for dev in dm.shard_plan_mode(part, _mesh(part)):
        _assert_placed_items(dev)


# rank -> slots a step of ec_sorted's kernel: 4 columns a lane where the
# rank is a multiple of 4 (a group of rank / 4 lanes), else one (a group of
# min(rank, 32) lanes); a warp holds 32 // group groups
STEP_WIDTH = {4: 32, 6: 5, 8: 16, 30: 1, 32: 4, 40: 3, 64: 2, 96: 1,
              100: 1, 128: 1}


def _item_walks(values, items, nblocks, block_p):
    """Each work item's slots up to its last nonzero value, item by item
    in numpy."""
    starts = _build.item_views(items, nblocks).item_starts.numpy()
    walks = []
    for b0, b1 in zip(starts[:-1], starts[1:]):
        if b0 >= nblocks:
            break
        nz = np.flatnonzero(values[b0 * block_p:b1 * block_p])
        walks.append(int(nz[-1]) + 1 if nz.size else 0)
    return walks


def test_step_width():
    assert {r: _build.step_width(r) for r in STEP_WIDTH} == STEP_WIDTH
    for rank in (0, 129, 256):
        with pytest.raises(ValueError, match="R in"):
            _build.step_width(rank)


@pytest.mark.parametrize("rank", [8, 30, 32, 64, 128])
@pytest.mark.parametrize("case", sorted(LONG_RUN) + sorted(PAD_STAGES))
def test_step_slots_count_each_items_steps(case, rank):
    """Split runs, short tiles, mid-run zeros, trailing pad blocks: each
    item walks its slots up to its last nonzero value in steps of
    ``step_width(rank)``, its last step as wide as the others."""
    part, *_ = {**LONG_RUN, **PAD_STAGES}[case]()
    g = STEP_WIDTH[rank]
    for dev in dm.shard_plan_mode(part, _mesh(part)):
        nb = dev.block_to_tile.numel()
        walks = _item_walks(dev.values.numpy(), dev.items, nb, part.block_p)
        chunks = _build.item_views(dev.items, nb)
        steps = _build.step_slots(dev.values, chunks, part.block_p, rank)
        assert steps == sum(-(-n // g) * g for n in walks)
        assert _build.walked_slots(dev.values, chunks,
                                   part.block_p) == sum(walks)
        assert steps % g == 0 and sum(walks) <= steps < sum(walks) + g * len(
            walks)


def _config_tensor(name, seed=2**31 + 5):
    """Configuration ``name`` at its ``tests`` cut, drawn by the
    benchmark's own generator, and its solver config."""
    conf = json.loads((ROOT / "chipbench" / "configs" / f"{name}.json")
                      .read_text())
    spec = importlib.util.spec_from_file_location(
        "placed_items_bench_tensor",
        ROOT / "chipbench" / "traffic" / "tensor.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    shape, draws = gen.scaled_geometry(conf["shape"], conf["nnz"],
                                       conf["tests"]["scale"],
                                       conf["tests"]["mode_scale"])
    ind, val = gen.draw_coo(shape, draws, distribution=conf["distribution"],
                            zipf_a=conf.get("zipf_a", 1.0), seed=seed,
                            device="cpu")
    return SparseTensor(ind, val, shape), conf


@pytest.mark.parametrize("devices", [1, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_a_sweep_takes_every_shards_placed_items(name, devices):
    t, conf = _config_tensor(name)
    cfg = api.preset(conf["preset"], {**conf["overrides"],
                                      "rank": conf["rank"],
                                      "runtime.num_devices": devices})
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as solver:
        for mode in solver.dev_arrays:
            assert len(mode) == devices
            for dev in mode:
                _assert_placed_items(dev)
        placed = _counts()
        solver.sweep()
        assert _counts() == placed + t.nmodes * devices


def _store_plan(tmp_path):
    t = skewed_tensor()
    path = str(tmp_path / "s.store")
    write_store_from_coo(t, path, chunk_nnz=512)
    plan = build_plan_from_store(TensorStore(path), 2, strategy="equal_nnz")
    budget = max(p.nnz_max for p in plan.modes) * 20
    sps = [split_mode_super_shards(p, budget) for p in plan.modes]
    assert max(sp.num_shards for sp in sps) >= 2
    return plan, sps, dm.cp_mesh(2, 2, devices=["cpu"] * 2)


@pytest.mark.parametrize("rank", [8, 32])
@pytest.mark.parametrize("name", CONFIGS)
def test_compile_sets_the_step_fill_share_of_every_mode(name, rank):
    """``api.compile`` sets ``ec.step_fill_share.mode<d>`` for every mode:
    the walked slots of its shards over their steps' lane groups at the
    config's rank, on the configurations' ``tests`` cuts."""
    t, conf = _config_tensor(name)
    cfg = api.preset(conf["preset"], {**conf["overrides"], "rank": rank,
                                      "runtime.num_devices": 2})
    plan = api.plan(t, cfg, device="cpu")
    reg = obs.get_registry()
    names = [f"ec.step_fill_share.mode{d}" for d in range(t.nmodes)]
    for n in names:
        reg.set_gauge(n, None)
    with api.compile(plan, cfg, device="cpu") as solver:
        for n, mode in zip(names, solver.dev_arrays):
            walked = steps = 0
            for dev in mode:
                chunks = _build.item_views(dev.items,
                                           dev.block_to_tile.numel())
                bp = plan.modes[names.index(n)].block_p
                walked += _build.walked_slots(dev.values, chunks, bp)
                steps += _build.step_slots(dev.values, chunks, bp, rank)
            assert reg.gauge(n) == walked / steps
            assert 0 < reg.gauge(n) <= 1


def test_streamed_windows_carry_their_own_items(tmp_path):
    """Each window's items are its own ``block_to_tile``'s (not the
    resident shard's), built fresh, and again after the spill replays the
    window's five arrays."""
    plan, sps, mesh = _store_plan(tmp_path)
    spill = st.WindowSpill()
    fresh = {}
    with st.SuperShardStreamer(plan, mesh, sps, buffers=2,
                               spill=spill) as s:
        for sweep in range(2):
            for d, sp in enumerate(sps):
                for k in range(sp.num_shards):
                    got = s.get(d, k)
                    unspilled = dm.shard_super_shard(plan.modes[d], sp, k,
                                                     mesh).arrays
                    for dev, ref in zip(got, unspilled, strict=True):
                        _assert_placed_items(dev)
                        assert torch.equal(dev.items, ref.items)
                    if sweep == 0:
                        fresh[d, k] = [dev.items for dev in got]
                    else:
                        for a, dev in zip(fresh[d, k], got, strict=True):
                            assert torch.equal(a, dev.items)
        hits, saves = spill.counters()
        assert hits > 0 and saves > 0


def _rebalance_cfg(rebalance):
    return api.paper({"rank": 8, "runtime.tol": 0.0,
                      "runtime.num_devices": 4,
                      "partition.strategy": "equal_nnz",
                      "kernel.variant": "sorted", "kernel.use_kernel": True,
                      "partition.layout": "sorted",
                      "schedule.rebalance": rebalance,
                      "schedule.cadence": 1,
                      "schedule.imbalance_threshold": 1.1,
                      "schedule.migration_budget": 0.4})


def test_migrated_modes_are_re_placed_with_their_items():
    """After the rebalancer migrates nonzeros, the re-placed modes carry
    the new plan's items; its probes, on block-trimmed views, are given
    the trimmed blocks' own, and count as placed too."""
    t = skewed_tensor()
    cfg = _rebalance_cfg("on")
    solver = api.compile(api.plan(t, cfg), cfg, device="cpu")
    placed = _counts()
    sweeps = 5
    solver.run(sweeps)
    moved = [e for e in solver.schedule_events if e["moved_nnz"] > 0]
    assert moved and solver.plan.rebalance_epoch >= 1
    for mode, part in enumerate(solver.plan.modes):
        for k, dev in enumerate(solver.dev_arrays[mode]):
            np.testing.assert_array_equal(dev.block_to_tile.numpy(),
                                          part.block_to_tile[k])
            _assert_placed_items(dev)
    probes = sum(sum(len(p) for p in x["probe_s"].values())
                 for x in solver.rebalance_timings)
    assert probes > 0
    assert _counts() - placed >= sweeps * t.nmodes * 4 + probes
    solver.close()


def test_item_buffers_takes_placed_items_as_they_are():
    """``item_buffers`` opens no span and hands out views of the placed
    items, and takes no call without them; a launch refuses items of
    another shape."""
    from repro_torch.obs import trace as obs_trace
    b2t = torch.tensor([0] * 20 + [1, 1, 2], dtype=torch.int32)
    items = _build.pack_items(b2t)
    geo = dict(num_rows=24, tile=8, rank=4, nin=2, num_buffers=2)
    obs.reset()
    obs_trace.enable()
    try:
        out, chunks, partials, _ = _build.item_buffers(
            "sorted", b2t, items=items, **geo)
        assert obs_trace.get_tracer().records() == []
    finally:
        obs.reset()
    assert chunks.item_starts.data_ptr() == items.data_ptr()
    want = _build.tile_chunks(b2t)
    for a, b in zip(chunks[:3], want[:3], strict=True):
        assert torch.equal(a, b)
    assert partials.shape == (want.n_parts, 8, 4) and not out.any()
    with pytest.raises(TypeError, match="items"):
        _build.item_buffers("sorted", b2t, **geo)
    with pytest.raises(ValueError, match="items has shape"):
        _build.count_items(items, b2t.numel() - 1, b2t.device)


# -- the EC's callers outside a sweep ----------------------------------------

def _probe():
    plan = build_plan(skewed_tensor(), 4, strategy="equal_nnz",
                      layout="sorted")
    part = plan.modes[0]
    mesh = dm.cp_mesh(4, part.r, devices=["cpu"] * 4)
    factors = als.init_factors(plan, 8, seed=1, devices=mesh.devices)
    arrays = dm.shard_plan_mode(part, mesh)
    reb.measure_mode_device_times(
        part, factors, dict(use_kernel=True, variant="sorted",
                            num_buffers=2), arrays=arrays, repeats=2)


def _tuner():
    t, part = autotune.representative_shard(3, 2048, layout="sorted")
    autotune._time_candidate(t, part, 8, "sorted", 2, 2, torch.device("cpu"))


def _audit():
    hlo_audit.ec_recorded_ops("sorted", nmodes=3, rank=8, device="cpu")


@pytest.mark.parametrize("caller", ["probe", "tuner", "audit"])
def test_callers_outside_a_sweep_launch_with_placed_items(caller,
                                                          monkeypatch):
    """The rebalancer's probe, the tuner and the audit take their shards
    from ``place_shard`` (the probe a trimmed view of one, with its own
    items): each of their EC calls counts one ``ec.items.placed``."""
    calls = []
    local = ops.mttkrp_local

    def counted(*args, **kw):
        assert kw["items"] is not None
        calls.append(kw["variant"])
        return local(*args, **kw)

    monkeypatch.setattr(ops, "mttkrp_local", counted)
    placed = _counts()
    {"probe": _probe, "tuner": _tuner, "audit": _audit}[caller]()
    assert calls and set(calls) == {"sorted"}
    assert _counts() - placed == len(calls)


# -- no mask: the rows of unvisited tiles are +0.0 ---------------------------

def _resident_plan():
    return build_plan(skewed_tensor(), 4, strategy="equal_nnz",
                      layout="sorted")


def _resident(tmp_path):
    plan = _resident_plan()
    return [(plan, d, dm.shard_plan_mode(
        part, dm.cp_mesh(4, part.r, devices=["cpu"] * 4)))
        for d, part in enumerate(plan.modes)]


def _windows(tmp_path):
    """Every window of every mode, the empty ``(0, 0)`` ones included."""
    plan, sps, mesh = _store_plan(tmp_path)
    out = [(plan, d, dm.shard_super_shard(plan.modes[d], sp, k, mesh).arrays)
           for d, sp in enumerate(sps) for k in range(sp.num_shards)]
    assert any(t0 == t1 for sp in sps for w in sp.windows for t0, t1 in w)
    return out


def _migrated(tmp_path):
    plan = _resident_plan()
    migs = reb.plan_group_migrations(plan.modes[0],
                                     np.array([1.0, 2.0, 2.0, 8.0]),
                                     migration_budget=0.3)
    new, applied = reb.apply_rebalance(plan, reb.ReplanDecision(
        epoch=plan.rebalance_epoch, sweep=1, triggered=True, imbalance={},
        modelled_imbalance={}, migrations=tuple(migs)))
    assert sum(a["moved_nnz"] for a in applied) > 0
    part = new.modes[0]
    return [(new, 0, dm.shard_plan_mode(
        part, dm.cp_mesh(4, part.r, devices=["cpu"] * 4)))]


def _trimmed(tmp_path):
    out = [(plan, d, [reb.trimmed_device_args(plan.modes[d], dev, k)
                      for k, dev in enumerate(shards)])
           for plan, d, shards in _resident(tmp_path)]
    assert any((p.blocks_true < p.nblocks).any() for p in out[0][0].modes)
    return out


SHARDS = {"resident": _resident, "streamed_window": _windows,
          "migrated": _migrated, "probe_trimmed": _trimmed}
EC_ARGS = ("indices", "values", "local_rows", "block_to_tile", "seg_starts",
           "seg_rows", "items")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("producer", sorted(SHARDS))
def test_rows_of_unvisited_tiles_are_positive_zero(producer, variant,
                                                   tmp_path):
    """Every output row outside the tiles of a shard's ``block_to_tile``
    is +0.0 bit for bit, with NaN in row 0 (the pads' row) of every input
    factor: the EC writes only its blocks' tiles into a zeroed output, so
    the mask the reference applies after its kernel would change no bit."""
    checked = 0
    for plan, mode, shards in SHARDS[producer](tmp_path):
        part = plan.modes[mode]
        factors = als.init_factors(plan, 4, seed=2,
                                   devices=["cpu"] * len(shards))
        for k, dev in enumerate(shards):
            a = dev if isinstance(dev, dict) else \
                {n: getattr(dev, n) for n in EC_ARGS}
            facs = [f[k].clone() for f in factors]
            for w, f in enumerate(facs):
                if w != mode:
                    f[0] = float("nan")
            out = ops.mttkrp_local(
                factors=facs, mode=mode, num_rows=part.rows_max,
                tile=part.tile, block_p=part.block_p, variant=variant, **a)
            visited = torch.zeros(part.rows_max // part.tile,
                                  dtype=torch.bool)
            visited[a["block_to_tile"].long()] = True
            outside = ~visited.repeat_interleave(part.tile)
            assert (out[outside].view(torch.int32) == 0).all()
            checked += int(outside.sum())
    assert checked > 0
