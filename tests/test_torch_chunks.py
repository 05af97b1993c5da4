"""Work items and the two-level order of the port's EC kernels.

A tile's run of more than ``CHUNK_BLOCKS`` kernel blocks is cut into work
items; the CUDA kernels sum each item in slot order and the items' partials
in item order. Here, on the CPU: ``tile_chunks`` (the items the kernels
launch over), and the plain versions — which is what a CPU tensor runs —
on shards with such runs:

* bitwise equal to an independent numpy two-level sum (``np.add.at`` per
  chunk, then the chunks in order);
* within rtol 1e-5 / atol 1e-5·max|ref| of the reference's slot-order
  ``ref`` and of its ``ec_sorted`` Pallas kernel in interpret mode: rows of
  a few hundred f32 terms summed in another grouping differ in the last
  bits only; ``blocked`` also within 2e-4 of the reference's ``ec_blocked``
  (its one-hot product's own tolerance, test_torch_kernels.py);
* the same bits for every ``num_buffers``, and for ``sorted``, ``fused``
  and ``blocked`` alike.

Also the slots ``ec_sorted``'s kernel walks (``_build.walked_slots``): up to
each item's last nonzero value, so on a shard whose every entry is nonzero
its tiles' entries, no more; the slots and partials of the split path
(``_build.split_slots``), against hand counts; and the per-mode gauges
``api.compile`` sets from them.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from _torch_cases import (LONG_RUN, PAD_STAGES, longest_run,  # noqa: E402
                          partitioned_case, shard_arrays)
from repro.kernels import ops as j_ops  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.core.partition import block_device_rows  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ref import ec_rows_chunked, ec_rows_ref  # noqa: E402

C = _build.CHUNK_BLOCKS
TOL = 1e-5
BLOCKED_TOL = 2e-4


# -- tile_chunks --------------------------------------------------------------

def _items(b2t, chunk_blocks):
    """(items as (start, end, part), split runs as (first, n, tile))."""
    c = _build.tile_chunks(torch.tensor(b2t, dtype=torch.int32),
                           chunk_blocks)
    nb = len(b2t)
    assert c.item_starts.dtype == c.item_part.dtype == c.split.dtype == \
        torch.int32
    assert c.item_starts.shape == (nb + 1,) and c.item_part.shape == (nb,)
    assert c.split.shape == (3, nb // chunk_blocks)
    assert c.n_parts == 2 * nb // chunk_blocks
    starts = c.item_starts.tolist()
    n = starts.index(nb) if nb else 0
    assert starts[n:] == [nb] * (nb + 1 - n)
    assert c.item_part.tolist()[n:] == [-1] * (nb - n)
    items = [(starts[i], starts[i + 1], int(c.item_part[i]))
             for i in range(n)]
    split = [tuple(col) for col in c.split.T.tolist() if col[0] >= 0]
    assert all(col == [-1, -1, -1] for col in c.split.T.tolist()[len(split):])
    return items, split


def _runs(b2t):
    b2t = np.asarray(b2t)
    if not b2t.size:
        return []
    edges = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


def _check_cover(b2t, chunk_blocks):
    items, split = _items(b2t, chunk_blocks)
    it = iter(items)
    next_part, split_seen = 0, []
    for r0, r1 in _runs(b2t):
        length = r1 - r0
        if length <= chunk_blocks:  # one item, writing its tile
            assert next(it) == (r0, r1, -1)
            continue
        n = -(-length // chunk_blocks)
        for k in range(n):  # in order, each <= chunk_blocks blocks
            b = r0 + k * chunk_blocks
            assert next(it) == (b, min(b + chunk_blocks, r1), next_part + k)
        split_seen.append((next_part, n, int(b2t[r0])))
        next_part += n
    assert next(it, None) is None
    assert split == split_seen
    assert next_part <= 2 * len(b2t) // chunk_blocks
    return items


@pytest.mark.parametrize("b2t,chunk_blocks,expect", [
    ([0, 0, 3, 3, 3, 4, 7, 7], 3, [(0, 2, -1), (2, 5, -1), (5, 6, -1),
                                   (6, 8, -1)]),
    ([0, 0, 3, 3, 3, 3, 3, 4, 7, 7, 7, 7, 7, 7, 7], 3,
     [(0, 2, -1), (2, 5, 0), (5, 7, 1), (7, 8, -1), (8, 11, 2), (11, 14, 3),
      (14, 15, 4)]),
    ([5], 16, [(0, 1, -1)]),
    ([], 16, []),
    ([1] * 16, 16, [(0, 16, -1)]),
    ([1] * 17, 16, [(0, 16, 0), (16, 17, 1)]),
    ([2] * 3 + [0] * 40, 16, [(0, 3, -1), (3, 19, 0), (19, 35, 1),
                             (35, 43, 2)]),
    # chunk_blocks at least the longest run: one item a run, item_starts
    # the runs' first blocks
    ([0, 0, 3, 3, 3, 4, 7, 7], 16, [(0, 2, -1), (2, 5, -1), (5, 6, -1),
                                    (6, 8, -1)]),
    ([5], 1, [(0, 1, -1)]),
    ([], 1, []),
    ([1, 1, 1], 3, [(0, 3, -1)]),
])
def test_tile_chunks(b2t, chunk_blocks, expect):
    assert _check_cover(b2t, chunk_blocks) == expect


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tile_chunks_random_runs(seed):
    """Random run lengths around C: every run covered once, in order, by
    items of at most C blocks; runs of at most C blocks are one item."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3 * C + 2, size=rng.integers(1, 30))
    tiles = rng.permutation(len(lengths) + 5)[:len(lengths)]
    b2t = np.repeat(tiles, lengths).astype(np.int32)
    _check_cover(b2t, C)


def test_tile_chunks_default_is_chunk_blocks():
    b2t = torch.zeros(2 * C + 1, dtype=torch.int32)
    c = _build.tile_chunks(b2t)
    assert c.item_starts[:4].tolist() == [0, C, 2 * C, 2 * C + 1]
    assert c.split[:, 0].tolist() == [0, 3, 0]


# -- the plain versions on runs longer than C blocks -------------------------

def _numpy_two_level(a, factors, mode, part):
    """The fixed two-level order written out in numpy: a run of <= C
    blocks in slot order; a longer run as per-chunk (tile, R) partials in
    slot order (np.add.at), added from 0 in chunk order."""
    tile, block_p = part.tile, part.block_p
    e = a["values"][:, None].astype(np.float32)
    for w, f in enumerate(factors):
        if w != mode:
            e = e * f[a["indices"][:, w]]
    rows = a["local_rows"].astype(np.int64)
    b2t = a["block_to_tile"]
    out = np.zeros((part.rows_max, e.shape[1]), np.float32)
    for r0, r1 in _runs(b2t):
        if r1 - r0 <= C:
            sl = slice(r0 * block_p, r1 * block_p)
            np.add.at(out, rows[sl], e[sl])
            continue
        base = int(b2t[r0]) * tile
        total = np.zeros((tile, e.shape[1]), np.float32)
        for b in range(r0, r1, C):
            sl = slice(b * block_p, min(b + C, r1) * block_p)
            p = np.zeros_like(total)
            np.add.at(p, rows[sl] - base, e[sl])
            total = total + p
        out[base:base + tile] = total
    return out


def _port(a, part, factors, variant, mode, num_buffers=2):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return ops.mttkrp_local(
        t["indices"], t["values"], t["local_rows"], t["block_to_tile"],
        [torch.from_numpy(f) for f in factors], mode=mode,
        num_rows=part.rows_max, tile=part.tile, block_p=part.block_p,
        variant=variant, num_buffers=num_buffers,
        seg_starts=t["seg_starts"], seg_rows=t["seg_rows"],
        items=t["items"]).numpy()


def _jax(a, part, factors, variant, mode):
    return np.asarray(j_ops.mttkrp_local(
        jnp.asarray(a["indices"]), jnp.asarray(a["values"]),
        jnp.asarray(a["local_rows"]), jnp.asarray(a["block_to_tile"]),
        [jnp.asarray(f) for f in factors], mode=mode,
        num_rows=part.rows_max, tile=part.tile, block_p=part.block_p,
        variant=variant, interpret=True,
        tile_mask=jnp.asarray(a["tile_visited"]),
        seg_starts=jnp.asarray(a["seg_starts"]),
        seg_rows=jnp.asarray(a["seg_rows"])))


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_chunked_plain_equals_numpy_two_level(case, variant):
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    assert longest_run(a["block_to_tile"]) > C
    got = _port(a, part, factors, variant, mode)
    np.testing.assert_array_equal(got, _numpy_two_level(a, factors, mode,
                                                        part))


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_chunked_plain_near_reference(case, variant):
    """Against the reference's slot-order ``ref`` and its ``ec_sorted``
    Pallas kernel (interpret mode), which agree with each other bitwise."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    got = _port(a, part, factors, variant, mode)
    for ref_variant in ("ref", "sorted"):
        want = _jax(a, part, factors, ref_variant, mode)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_blocked_plain_near_jax_blocked(case):
    """Against the reference's ``ec_blocked`` (interpret mode) on the same
    pre-gathered rows, at its own 2e-4."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    np.testing.assert_allclose(_port(a, part, factors, "blocked", mode),
                               _jax(a, part, factors, "blocked", mode),
                               rtol=BLOCKED_TOL, atol=BLOCKED_TOL)


@pytest.mark.parametrize("variant", ["sorted", "fused"])
@pytest.mark.parametrize("num_buffers", [3, 4])
def test_chunked_plain_num_buffers_same_bits(variant, num_buffers):
    part, factors, mode, dev = LONG_RUN["hot_row_4mode"]()
    a = shard_arrays(part, dev)
    np.testing.assert_array_equal(
        _port(a, part, factors, variant, mode, num_buffers=num_buffers),
        _port(a, part, factors, variant, mode, num_buffers=2))


@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_sorted_and_fused_plain_agree_bitwise(case):
    """Both kernels compute one function in one order, from descriptors
    or from per-slot rows."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    np.testing.assert_array_equal(_port(a, part, factors, "sorted", mode),
                                  _port(a, part, factors, "fused", mode))


@pytest.mark.parametrize("case", sorted(LONG_RUN))
def test_blocked_and_fused_plain_agree_bitwise(case):
    """One kernel body, one order: the rows gathered before the kernel or
    inside it are the same f32 values."""
    part, factors, mode, dev = LONG_RUN[case]()
    a = shard_arrays(part, dev)
    np.testing.assert_array_equal(_port(a, part, factors, "blocked", mode),
                                  _port(a, part, factors, "fused", mode))


def test_chunked_equals_slot_order_on_short_runs():
    """With every run at most ``chunk_blocks`` blocks the two-level order
    is the slot order, bit for bit; with a smaller chunk it is not."""
    part, factors, mode, dev = LONG_RUN["hot_row_3mode"]()
    a = {k: torch.from_numpy(v) for k, v in shard_arrays(part, dev).items()}
    gathered = [torch.from_numpy(f).index_select(0, a["indices"][:, w])
                for w, f in enumerate(factors) if w != mode]
    args = (a["values"], gathered, a["local_rows"], part.rows_max,
            a["block_to_tile"])
    geo = dict(tile=part.tile, block_p=part.block_p)
    slot_order = ec_rows_chunked(*args, **geo, chunk_blocks=part.nblocks)
    assert torch.equal(slot_order, ec_rows_ref(*args[:4]))
    split = ec_rows_chunked(*args, **geo, chunk_blocks=4)
    assert not torch.equal(split, slot_order)
    torch.testing.assert_close(split, slot_order, rtol=TOL,
                               atol=TOL * float(slot_order.abs().max()))


# -- the slots the item kernel walks -----------------------------------------

def _entries(tile_counts):
    """Σ over tiles of their entries: what the kernel walks where every
    entry is nonzero."""
    return int(np.asarray(tile_counts, np.int64).sum())


def _chunks(b2t):
    """The views of a shard's placed work items (``_build.item_views`` of
    ``pack_items``), which ``api.compile``'s gauges read."""
    b2t = torch.from_numpy(np.asarray(b2t, np.int32))
    return _build.item_views(_build.pack_items(b2t), b2t.numel())


def _walked(values, b2t, block_p):
    return _build.walked_slots(torch.from_numpy(values), _chunks(b2t),
                               block_p)


def _tile_counts(part, dev):
    """Each run's entries on a shard whose every entry is nonzero: the
    nonzero values of its blocks, which must add up to ``nnz_true``."""
    nz = (part.values[dev].reshape(-1, part.block_p) != 0).sum(1)
    tc = np.bincount(part.block_to_tile[dev], weights=nz)
    assert tc.sum() == part.nnz_true[dev]
    return tc


@pytest.mark.parametrize("layout", ["sorted", "blocked"])
@pytest.mark.parametrize("nmodes,num_devices,replication,block_p,seed", [
    (3, 1, 1, 128, 0), (3, 1, 1, 16, 1), (4, 2, 1, 16, 2), (3, 4, 2, 16, 3),
    (5, 4, 1, 32, 4)])
def test_walked_slots_on_partitioned_plans(layout, nmodes, num_devices,
                                           replication, block_p, seed):
    """Every shard of a zipf plan, a mesh's trailing pad blocks and split
    runs among them: a tile's entries, no more."""
    part, _ = partitioned_case(nmodes, 8, seed=seed, nnz=800,
                               num_devices=num_devices,
                               replication=replication, block_p=block_p,
                               layout=layout)
    for dev in range(part.num_devices):
        want = _entries(_tile_counts(part, dev))
        got = _walked(part.values[dev], part.block_to_tile[dev], block_p)
        assert got == want == part.nnz_true[dev]
        assert got <= part.values[dev].size


def _shard(tile_counts, *, layout, tile=4, block_p=16, pad_blocks=0,
           seed=0):
    """One device's blocked values and ``block_to_tile`` from
    ``block_device_rows`` with ``tile_counts[i]`` entries in tile ``i``
    (nonzero values), then ``pad_blocks`` trailing pad blocks on the last
    tile, as ``partition_mode`` pads a shard to the mesh's longest."""
    rng = np.random.default_rng(seed)
    tiles = np.repeat(np.arange(len(tile_counts)), tile_counts)
    lrow = np.sort(tiles * tile + rng.integers(0, tile, tiles.size))
    vals = rng.uniform(0.5, 1.5, lrow.size).astype(np.float32)
    inds = rng.integers(0, 5, (lrow.size, 2))
    _, v, _, b2t = block_device_rows(lrow, vals, inds,
                                     n_tiles=len(tile_counts), tile=tile,
                                     block_p=block_p, layout=layout)
    v = np.concatenate([v, np.zeros(pad_blocks * block_p, np.float32)])
    b2t = np.concatenate([b2t, np.full(pad_blocks, b2t[-1])])
    return v, b2t.astype(np.int32)


@pytest.mark.parametrize("layout", ["sorted", "blocked"])
@pytest.mark.parametrize("case,counts,pad_blocks", [
    ("one_to_seven_a_tile", [1, 2, 3, 4, 5, 6, 7, 0, 3], 0),
    ("last_block_full", [16, 32, 5, 48], 0),
    ("trailing_pad_blocks", [3, 20, 9], 5),
    ("trailing_pad_blocks_split_the_last_run", [3, 20, 9], 20),
    ("split_run", [7, 16 * 16 + 3, 2], 0),
    ("split_run_full_items", [5, 16 * 16 * 2, 1], 0),
    ("run_at_chunk_blocks", [7, 16 * 16, 2], 0),
    ("run_just_under_chunk_blocks", [7, 15 * 16, 2], 0),
    ("run_just_over_chunk_blocks", [7, 16 * 16 + 1, 2], 0),
])
def test_walked_slots_tile_counts(layout, case, counts, pad_blocks):
    v, b2t = _shard(counts, layout=layout, pad_blocks=pad_blocks)
    if "split" in case:
        assert longest_run(b2t) > C
    assert _walked(v, b2t, 16) == _entries(counts)


# (counts, pad_blocks, tile, split slots, partials) at block_p 16, so a
# tile of n entries is a run of ceil(n / 16) blocks, split (into ceil(blocks
# / 16) partials) past 16 blocks; trailing pad blocks join the last run.
SPLIT_CASES = {
    "one_to_seven_a_tile": ([1, 2, 3, 4, 5, 6, 7, 0, 3], 0, 4, 0, 0),
    "trailing_pad_blocks": ([3, 20, 9], 5, 4, 0, 0),
    # the last run: 1 block of entries and 20 pads, 21 blocks in 2 items
    "trailing_pad_blocks_split_the_last_run": ([3, 20, 9], 20, 4,
                                               21 * 16, 2),
    "run_at_chunk_blocks": ([7, 16 * 16, 2], 0, 4, 0, 0),
    "run_just_under_chunk_blocks": ([7, 15 * 16, 2], 0, 4, 0, 0),
    "run_just_over_chunk_blocks": ([7, 16 * 16 + 1, 2], 0, 4, 17 * 16, 2),
    "split_run_full_items": ([5, 16 * 16 * 2, 1], 0, 4, 32 * 16, 2),
    # a 46-row mode at tile 8: 6 tiles, each one run of 28-39 blocks,
    # split into 2 or 3 items: 3 + 3 + 3 + 3 + 3 + 2 partials
    "six_tiles_of_a_46_row_mode": ([600, 550, 580, 620, 590, 440], 0, 8,
                                   (38 + 35 + 37 + 39 + 37 + 28) * 16, 17),
}


@pytest.mark.parametrize("layout", ["sorted", "blocked"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_slots_tile_counts(layout, case):
    """The slots of runs longer than CHUNK_BLOCKS and the partials their
    items write, against hand counts; the walked slots of the same shard."""
    counts, pad_blocks, tile, slots, partials = SPLIT_CASES[case]
    v, b2t = _shard(counts, layout=layout, tile=tile, pad_blocks=pad_blocks)
    assert _build.split_slots(_chunks(b2t), 16) == (slots, partials)
    assert (slots > 0) == (longest_run(b2t) > C)
    assert _walked(v, b2t, 16) == _entries(counts)


def test_split_slots_of_no_blocks():
    assert _build.split_slots(_chunks(np.zeros(0, np.int32)), 128) == (0, 0)


@pytest.mark.parametrize("layout", ["sorted", "blocked"])
def test_walked_slots_count_a_zero_value_mid_run(layout):
    """A real entry of value 0.0 before its run's last nonzero is walked,
    eight in a row too; at the run's end it is skipped like a pad."""
    counts = [12, 41, 6]
    v, b2t = _shard(counts, layout=layout)
    v[16 + 3] = 0.0                # tile 1, first block
    v[16 + 16 + 8:16 + 16 + 16] = 0.0  # tile 1, eight in a row mid-run
    assert _walked(v, b2t, 16) == _entries(counts)
    v[16 + 40] = 0.0               # tile 1's last entry
    assert _walked(v, b2t, 16) == _entries(counts) - 1
    v[16 + 39] = 0.0               # and the one before it
    assert _walked(v, b2t, 16) == _entries(counts) - 2


@pytest.mark.parametrize("case", sorted(
    set(PAD_STAGES) - {"mid_run_zero_values"}) + sorted(LONG_RUN))
def test_walked_slots_on_the_card_tests_shards(case):
    """The shards the card tests hold the kernels on, whose every entry is
    nonzero: each tile's entries."""
    part, _, _, dev = {**PAD_STAGES, **LONG_RUN}[case]()
    got = _walked(part.values[dev], part.block_to_tile[dev], part.block_p)
    assert got == _entries(_tile_counts(part, dev))


def test_compile_sets_the_walked_slot_share_of_every_mode():
    """``api.compile`` sets ``ec.walked_slot_share.mode<d>`` for every
    mode: the walked slots of its shards over the slots placed."""
    t = random_sparse((30, 20, 12, 9), 600, seed=5, distribution="zipf")
    cfg = api.preset("paper", {
        "rank": 4, "runtime.num_devices": 2, "runtime.seed": 0,
        "kernel.variant": "sorted", "kernel.autotune": False,
        "partition.layout": "sorted"})
    plan = api.plan(t, cfg, device="cpu")
    reg = obs.get_registry()
    names = [f"ec.walked_slot_share.mode{d}" for d in range(t.nmodes)]
    for name in names:
        reg.set_gauge(name, None)
    with api.compile(plan, cfg, device="cpu"):
        for name, part in zip(names, plan.modes):
            walked = sum(_walked(part.values[k], part.block_to_tile[k],
                                 part.block_p)
                         for k in range(part.num_devices))
            share = reg.gauge(name)
            assert share == walked / part.values.size
            assert 0 < share < 1


def test_compile_sets_the_split_path_gauges_of_every_mode():
    """``api.compile`` sets ``ec.split_slot_share.mode<d>`` and
    ``ec.partials.mode<d>`` for every mode: the slots of its shards in split
    runs over the slots placed, and the partials those runs' items write.
    The 46-row mode's tiles are each one long run on every device."""
    t = random_sparse((46, 2000, 2000), 6000, seed=5)
    cfg = api.preset("paper", {
        "rank": 4, "runtime.num_devices": 2, "runtime.seed": 0,
        "kernel.variant": "sorted", "kernel.autotune": False,
        "partition.layout": "sorted", "partition.tile": 8,
        "partition.block_p": 16})
    plan = api.plan(t, cfg, device="cpu")
    reg = obs.get_registry()
    names = [(f"ec.split_slot_share.mode{d}", f"ec.partials.mode{d}")
             for d in range(t.nmodes)]
    for share, parts in names:
        reg.set_gauge(share, None)
        reg.set_gauge(parts, None)
    with api.compile(plan, cfg, device="cpu"):
        for (share, parts), part in zip(names, plan.modes):
            counts = [_build.split_slots(_chunks(part.block_to_tile[k]),
                                         part.block_p)
                      for k in range(part.num_devices)]
            assert reg.gauge(share) == (sum(s for s, _ in counts)
                                        / part.values.size)
            assert reg.gauge(parts) == sum(p for _, p in counts)
    assert reg.gauge(names[0][0]) == 1.0
    assert reg.gauge(names[0][1]) >= 6 * 2
