"""The EC's work items placed with each shard, on the CPU.

A placed shard carries its work items (``DeviceArrays.items``): the
``(item_starts, item_part, split)`` of ``_build.tile_chunks`` on its
``block_to_tile``, packed in one int32 tensor (``_build.pack_items``) and
computed once at placement, so no EC launch of a sweep builds them. Held
here: the placed items are bitwise ``tile_chunks`` of the placed
``block_to_tile`` on resident shards (the split-run and pad-slot cases, the
benchmark configurations' ``tests`` cuts), on streamed windows with and
without the window spill, and on the modes re-placed after a rebalance
migration; a sweep counts ``nmodes × devices`` launches that were given
their items (``ec.items.placed``) and none that built them
(``ec.items.built``); the rebalancer's probe and a direct kernel call
build theirs, and count so.
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
from repro_torch.core import mttkrp as dm  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mttkrp_sorted import ec_sorted  # noqa: E402
from repro_torch.sparse import stream as st  # noqa: E402
from repro_torch.store import (TensorStore, build_plan_from_store,  # noqa: E402
                               split_mode_super_shards, write_store_from_coo)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ["amazon-r32", "twitch-r32", "patents-r32"]
PLACED, BUILT = "ec.items.placed", "ec.items.built"


def _counts():
    reg = obs.get_registry()
    return reg.counter(PLACED), reg.counter(BUILT)


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
        placed, built = _counts()
        solver.sweep()
        assert _counts() == (placed + t.nmodes * devices, built)


def _store_plan(tmp_path):
    t = skewed_tensor()
    path = str(tmp_path / "s.store")
    write_store_from_coo(t, path, chunk_nnz=512)
    plan = build_plan_from_store(TensorStore(path), 2, strategy="equal_nnz")
    budget = max(p.nnz_max for p in plan.modes) * 20
    sps = [split_mode_super_shards(p, budget) for p in plan.modes]
    assert max(sp.num_shards for sp in sps) >= 2
    return plan, sps, dm.cp_mesh(2, 2, devices=["cpu"] * 2)


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
    the new plan's items; its probes, on block-trimmed views, built their
    own."""
    t = skewed_tensor()
    cfg = _rebalance_cfg("on")
    solver = api.compile(api.plan(t, cfg), cfg, device="cpu")
    placed, built = _counts()
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
    p1, b1 = _counts()
    assert p1 - placed == sweeps * t.nmodes * 4
    assert b1 - built >= probes
    solver.close()


def test_a_call_without_items_builds_and_counts_them():
    part, factors, mode, dev = LONG_RUN["hot_row_3mode"]()
    placed = dm.shard_plan_mode(part, dm.cp_mesh(1, 1, devices=["cpu"]))[0]
    facs = [torch.from_numpy(f) for f in factors]
    kw = dict(mode=mode, num_rows=part.rows_max, tile=part.tile,
              block_p=part.block_p, variant="sorted",
              tile_mask=placed.tile_visited, seg_starts=placed.seg_starts,
              seg_rows=placed.seg_rows)
    args = (placed.indices, placed.values, placed.local_rows,
            placed.block_to_tile, facs)
    p0, b0 = _counts()
    given = ops.mttkrp_local(*args, items=placed.items, **kw)
    assert _counts() == (p0 + 1, b0)
    built = ops.mttkrp_local(*args, **kw)
    assert _counts() == (p0 + 1, b0 + 1)
    assert torch.equal(given, built)
    kargs = ops.kernel_args("sorted", *args, mode=mode, tile=part.tile,
                            seg_starts=placed.seg_starts,
                            seg_rows=placed.seg_rows)
    ec_sorted(*kargs, num_rows=part.rows_max, tile=part.tile,
              block_p=part.block_p)
    assert _counts() == (p0 + 1, b0 + 2)


def test_item_buffers_takes_placed_items_as_they_are():
    """Given the placed items, ``item_buffers`` opens no ``ec.items`` span
    and hands out views of them, and refuses items of another shape."""
    from repro_torch.obs import trace as obs_trace
    b2t = torch.tensor([0] * 20 + [1, 1, 2], dtype=torch.int32)
    items = _build.pack_items(b2t)
    obs.reset()
    obs_trace.enable()
    try:
        out, chunks, partials, _ = _build.item_buffers(
            "sorted", b2t, num_rows=24, tile=8, rank=4, nin=2,
            num_buffers=2, items=items)
        assert obs_trace.get_tracer().records() == []
    finally:
        obs.reset()
    assert chunks.item_starts.data_ptr() == items.data_ptr()
    want = _build.tile_chunks(b2t)
    for a, b in zip(chunks[:3], want[:3], strict=True):
        assert torch.equal(a, b)
    assert partials.shape == (want.n_parts, 8, 4) and not out.any()
    with pytest.raises(ValueError, match="items has shape"):
        _build.item_buffers("sorted", b2t[:-1], num_rows=24, tile=8, rank=4,
                            nin=2, num_buffers=2, items=items)
