"""Inputs shared by the port's tests (tests/test_torch_*.py).

numpy and repro_torch only — no jax — so the card's tests can use them on
a machine without jax. The grids and seeds are those of the reference's
tests/test_sorted_kernel.py and tests/test_kernels.py; the partitions come
from the port's planner, which test_torch_plan.py holds bitwise against the
reference's, so the JAX side of a parity test can take the same arrays.
"""
import dataclasses

import numpy as np

from repro_torch.core.coo import SparseTensor, random_sparse
from repro_torch.core.mttkrp import place_shard
from repro_torch.core.partition import partition_mode

SHAPE = (24, 18, 12, 10, 8)


def partitioned_case(nmodes, rank, *, seed, nnz=400, num_devices=1,
                     replication=1, tile=8, block_p=128, layout="sorted",
                     strategy="amped_cdf"):
    """A zipf tensor partitioned on mode 1, and random global-layout
    factors (single-device partitions keep indices untranslated)."""
    t = random_sparse(SHAPE[:nmodes], nnz, seed=seed, distribution="zipf")
    part, _, _ = partition_mode(t, 1, num_devices, strategy=strategy,
                                replication=replication, tile=tile,
                                block_p=block_p, layout=layout)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.normal(size=(t.shape[w], rank)).astype(np.float32)
               for w in range(nmodes)]
    return part, factors


def _factors(shape, seed, rank=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, rank)).astype(np.float32) for s in shape]


def empty_shard_case(layout="sorted"):
    """Two groups, every update on output index 0: one device owns no
    nonzeros (test_sorted_kernel.py:110, test_kernels.py:181)."""
    ind = np.zeros((50, 3), np.int64)
    ind[:, 1] = np.arange(50) % 7
    ind[:, 2] = np.arange(50) % 5
    t = SparseTensor(ind.astype(np.int32), np.ones(50, np.float32), (3, 7, 5))
    part, _, _ = partition_mode(t, 0, 2, strategy="amped_cdf", replication=1,
                                layout=layout)
    dev = int(np.argmin(part.nnz_true))
    assert part.nnz_true[dev] == 0
    return part, _factors(t.shape, 0), 0, dev


def single_segment_case():
    """One output row: a segment spanning >= 3 blocks
    (test_sorted_kernel.py:128)."""
    nnz = 50
    ind = np.zeros((nnz, 3), np.int64)
    ind[:, 0] = np.arange(nnz) % 5
    ind[:, 1] = 2
    ind[:, 2] = np.arange(nnz) // 5
    t = SparseTensor(ind.astype(np.int32),
                     np.random.default_rng(1).normal(size=nnz)
                     .astype(np.float32), (5, 7, 12))
    part, _, _ = partition_mode(t, 1, 1, tile=8, block_p=16, layout="sorted")
    assert part.nblocks >= 3 and len(np.unique(part.local_rows[0])) == 1
    return part, _factors(t.shape, 2), 1, 0


def trailing_pad_case():
    """A light shard padded with whole trailing pad blocks
    (test_sorted_kernel.py:153)."""
    nnz = 96
    ind = np.zeros((nnz, 3), np.int64)
    ind[:90, 1] = 0
    ind[90:, 1] = 2
    ind[:, 0] = np.arange(nnz) % 7
    ind[:, 2] = np.arange(nnz) // 7
    t = SparseTensor(ind.astype(np.int32),
                     np.random.default_rng(6).normal(size=nnz)
                     .astype(np.float32), (7, 4, 16))
    part, _, _ = partition_mode(t, 1, 2, strategy="amped_cdf", replication=1,
                                tile=4, block_p=32, layout="sorted")
    dev = int(np.argmin(part.nnz_true))
    blocks = part.values[dev].reshape(-1, part.block_p)
    assert part.nnz_true[dev] > 0 and (blocks == 0).all(axis=1).any()
    return part, _factors(t.shape, 7), 1, dev


def block_edge_case():
    """Every row owns exactly block_p nonzeros: segments end on block
    edges (test_sorted_kernel.py:181)."""
    block_p, rows = 16, 4
    nnz = block_p * rows
    ind = np.zeros((nnz, 3), np.int64)
    ind[:, 1] = np.arange(nnz) // block_p
    ind[:, 0] = np.arange(nnz) % 4
    ind[:, 2] = (np.arange(nnz) % block_p) // 4 + 4 * (np.arange(nnz)
                                                       // (4 * block_p))
    t = SparseTensor(ind.astype(np.int32),
                     np.random.default_rng(3).normal(size=nnz)
                     .astype(np.float32), (4, rows, 16))
    part, _, _ = partition_mode(t, 1, 1, tile=2, block_p=block_p,
                                layout="sorted")
    assert (part.values[0] != 0).all()
    return part, _factors(t.shape, 4), 1, 0


DEGENERATE_SORTED = {
    "empty_shard": empty_shard_case,
    "single_segment_spans_blocks": single_segment_case,
    "all_padding_trailing_block": trailing_pad_case,
    "segment_boundaries_on_block_edges": block_edge_case,
}


# -- runs longer than CHUNK_BLOCKS (16) blocks: split into work items ------

def longest_run(b2t):
    starts = np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1], True])
    return int(np.diff(starts).max()) if b2t.size else 0


def hot_row_case(nmodes=3, rank=8, *, seed=0, layout="sorted"):
    """One hot output row of 640 nonzeros (40 blocks of 16) among light
    ones: its tile's run is cut into items of 16 blocks inside the row's
    segment."""
    rng = np.random.default_rng(seed)
    shape = (20, 12, 10, 9, 7)[:nmodes]
    nnz_hot, nnz_light = 640, 90
    ind = np.stack([rng.integers(0, s, nnz_hot + nnz_light)
                    for s in shape], axis=1)
    ind[:nnz_hot, 1] = 2
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz_hot + nnz_light).astype(np.float32),
                     shape)
    part, _, _ = partition_mode(t, 1, 1, tile=8, block_p=16, layout=layout)
    assert longest_run(part.block_to_tile[0]) >= 40
    return part, _factors(shape, seed + 1, rank), 1, 0


def long_block_edge_case():
    """32 rows of exactly block_p nonzeros in one tile of 32: a run of 32
    blocks whose item boundary falls on a segment (and block) edge."""
    block_p, rows = 16, 32
    nnz = block_p * rows
    rng = np.random.default_rng(8)
    ind = np.zeros((nnz, 3), np.int64)
    ind[:, 1] = np.arange(nnz) // block_p
    ind[:, 0] = rng.integers(0, 5, nnz)
    ind[:, 2] = rng.integers(0, 11, nnz)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (5, rows, 11))
    part, _, _ = partition_mode(t, 1, 1, tile=rows, block_p=block_p,
                                layout="sorted")
    assert (part.values[0] != 0).all()
    assert longest_run(part.block_to_tile[0]) == rows
    return part, _factors(t.shape, 9), 1, 0


def long_trailing_pad_case():
    """A light shard (6 blocks) padded to the heavy one's 40 blocks: the
    pad blocks revisit its last tile, whose run of 40 blocks ends in an
    item of pad blocks only."""
    nnz_heavy, nnz_light = 640, 96
    nnz = nnz_heavy + nnz_light
    rng = np.random.default_rng(10)
    ind = np.zeros((nnz, 3), np.int64)
    ind[nnz_heavy:, 1] = 2
    ind[:, 0] = rng.integers(0, 7, nnz)
    ind[:, 2] = rng.integers(0, 16, nnz)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (7, 4, 16))
    part, _, _ = partition_mode(t, 1, 2, strategy="amped_cdf", replication=1,
                                tile=4, block_p=16, layout="sorted")
    dev = int(np.argmin(part.nnz_true))
    blocks = part.values[dev].reshape(-1, part.block_p)
    pad = (blocks == 0).all(axis=1)
    assert part.nnz_true[dev] > 0 and pad[-16:].all()
    assert longest_run(part.block_to_tile[dev]) > 32
    return part, _factors(t.shape, 11), 1, dev


def hot_row_whole_blocks_case():
    """One row alone in its tile, 640 nonzeros at block_p 16: a run of 40
    blocks that its one segment fills whole, split into items of 16, 16
    and 8 blocks; rank 64, two rows' worth of lane groups a step."""
    block_p, nnz = 16, 640
    rng = np.random.default_rng(18)
    ind = np.zeros((nnz, 3), np.int64)
    ind[:, 1] = 5
    ind[:, 0] = rng.integers(0, 9, nnz)
    ind[:, 2] = rng.integers(0, 13, nnz)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (9, 8, 13))
    part, _, _ = partition_mode(t, 1, 1, tile=8, block_p=block_p,
                                layout="sorted")
    assert (part.values[0] != 0).all() and part.nblocks == 40
    assert len(np.unique(part.local_rows[0])) == 1
    return part, _factors(t.shape, 19, rank=64), 1, 0


def segment_mid_step_case():
    """One tile of 4 rows holding 14, 18, 30 and 258 nonzeros at block_p
    16: at rank 32 (4 slots a step) a step holds the first row's last two
    slots and the next row's first two, and that row goes on in the next
    block; the same again at slot 62; the run of 20 blocks is split
    inside the last row's segment."""
    block_p, counts = 16, [14, 18, 30, 258]
    rng = np.random.default_rng(20)
    nnz = sum(counts)
    ind = np.zeros((nnz, 3), np.int64)
    ind[:, 1] = np.repeat(np.arange(4), counts)
    ind[:, 0] = rng.integers(0, 9, nnz)
    ind[:, 2] = rng.integers(0, 17, nnz)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (9, 4, 17))
    part, _, _ = partition_mode(t, 1, 1, tile=4, block_p=block_p,
                                layout="sorted")
    rows = part.local_rows[0]
    assert (part.values[0] != 0).all() and part.nblocks == 20
    assert rows[13] != rows[14] == rows[16] and rows[61] != rows[62]
    return part, _factors(t.shape, 21, rank=32), 1, 0


LONG_RUN = {
    "hot_row_3mode": lambda: hot_row_case(3, 8, seed=1),
    "hot_row_4mode": lambda: hot_row_case(4, 32, seed=2),
    "hot_row_5mode": lambda: hot_row_case(5, 8, seed=3),
    "hot_row_blocked_layout": lambda: hot_row_case(3, 32, seed=4,
                                                   layout="blocked"),
    "boundary_on_block_edge": long_block_edge_case,
    "all_padding_last_item": long_trailing_pad_case,
    "hot_row_fills_whole_blocks": hot_row_whole_blocks_case,
    "segment_ends_mid_step": segment_mid_step_case,
}


# -- items that end in pad stages: the item kernel stops at the last slot
# whose value is not 0 ----------------------------------------------------

def short_tiles_case(layout="sorted"):
    """Every tile holds 1 to 7 nonzeros, so nearly every work item is one
    block of one partial stage and pad stages after it."""
    rng = np.random.default_rng(12)
    counts = np.arange(40) % 7 + 1
    rows = np.repeat(np.arange(40) * 8, counts) + rng.integers(
        0, 8, counts.sum())
    nnz = rows.size
    ind = np.stack([rng.integers(0, 9, nnz), rows, rng.integers(0, 11, nnz)],
                   axis=1)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (9, 320, 11))
    part, _, _ = partition_mode(t, 1, 1, tile=8, block_p=128, layout=layout)
    assert (np.bincount(part.block_to_tile[0]) <= 1).all()
    return part, _factors(t.shape, 13), 1, 0


def mid_run_zero_case():
    """A fifth of the entries hold the value 0.0: zeros before a run's last
    nonzero are walked, zeros at a run's end are skipped with its pads, on
    runs of one block and on a run split into items."""
    rng = np.random.default_rng(14)
    shape = (9, 40, 11)
    nnz_hot, nnz_light = 300, 200
    ind = np.stack([rng.integers(0, s, nnz_hot + nnz_light)
                    for s in shape], axis=1)
    ind[:nnz_hot, 1] = 5
    vals = rng.normal(size=nnz_hot + nnz_light).astype(np.float32)
    vals[rng.random(vals.size) < 0.2] = 0.0
    t = SparseTensor(ind.astype(np.int32), vals, shape)
    part, _, _ = partition_mode(t, 1, 1, tile=4, block_p=16, layout="sorted")
    blocks = part.values[0].reshape(-1, part.block_p)
    nz = blocks != 0
    # a zero before a nonzero of its block: mid-run
    assert (~nz[:, :-1] & nz[:, 1:]).any()
    assert longest_run(part.block_to_tile[0]) > 16
    return part, _factors(shape, 15), 1, 0


def trailing_pad_step_back_case():
    """A light shard of short tiles padded to the heavy one's blocks: its
    last item is its last tile's one partial block and the trailing pad
    blocks after it, so the kernel steps back over whole pad blocks."""
    rng = np.random.default_rng(16)
    nnz_heavy, nnz_light = 160, 9
    nnz = nnz_heavy + nnz_light
    ind = np.zeros((nnz, 3), np.int64)
    ind[nnz_heavy:, 1] = [3, 3, 4, 6, 6, 6, 7, 7, 7]
    ind[:, 0] = rng.integers(0, 7, nnz)
    ind[:, 2] = rng.integers(0, 16, nnz)
    t = SparseTensor(ind.astype(np.int32),
                     rng.normal(size=nnz).astype(np.float32), (7, 8, 16))
    part, _, _ = partition_mode(t, 1, 2, strategy="amped_cdf", replication=1,
                                tile=2, block_p=16, layout="sorted")
    dev = int(np.argmin(part.nnz_true))
    pad = (part.values[dev].reshape(-1, part.block_p) == 0).all(axis=1)
    assert part.nnz_true[dev] > 0 and pad[-7:].all()
    assert longest_run(part.block_to_tile[dev]) <= 16
    return part, _factors(t.shape, 17), 1, dev


PAD_STAGES = {
    "short_tiles": short_tiles_case,
    "short_tiles_blocked_layout": lambda: short_tiles_case("blocked"),
    "mid_run_zero_values": mid_run_zero_case,
    "trailing_pad_blocks_step_back": trailing_pad_step_back_case,
}


def shard_arrays(part, dev=0):
    """One device's EC inputs as numpy arrays: its shard as
    ``core.mttkrp.place_shard`` places it (the sorted variant's segment
    descriptors and the packed work items included), and the partition's
    ``tile_visited``, the reference's ``tile_mask``."""
    shard, _ = place_shard(part, dev, "cpu")
    out = {f.name: getattr(shard, f.name).numpy()
           for f in dataclasses.fields(shard)}
    out["tile_visited"] = part.tile_visited[dev]
    return out


def blocked_case(nblocks, tile, n_tiles, p, r, nin, seed):
    """Direct ec_blocked inputs (test_kernels.py:13-26): a monotone
    block→tile map, random rows in tile, ~20 % zero values, and ``nin``
    pre-gathered (nnz, r) row arrays."""
    rng = np.random.default_rng(seed)
    nnz = nblocks * p
    b2t = np.sort(rng.integers(0, n_tiles, size=nblocks))
    rows_in_tile = rng.integers(0, tile, size=nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    vals[rng.random(nnz) < 0.2] = 0.0
    gathered = [rng.normal(size=(nnz, r)).astype(np.float32)
                for _ in range(nin)]
    return (b2t.astype(np.int32), rows_in_tile.astype(np.int32), vals,
            gathered)


# (tile, block_p, R, nin) of test_kernels.py:37-40
BLOCKED_SHAPES = [(8, 16, 8, 1), (8, 32, 16, 2), (16, 64, 32, 2),
                  (8, 128, 32, 4), (32, 32, 64, 3)]
# (seed, nblocks, n_tiles) standing in for test_kernels.py:78's property
BLOCKED_PROPERTY = [(0, 1, 1), (17, 3, 2), (404, 6, 4), (2024, 2, 3),
                    (9999, 5, 1)]


# -- the rebalancer's hot-index tensor ------------------------------------

def skewed_tensor(nnz=8000, seed=0, explicit_zero=False):
    """tests/test_schedule.py's hot-index tensor: a few indices of mode 0
    carry most nonzeros, the rest scatter, so equal-nnz members execute
    very different block counts. ``explicit_zero`` stores one genuine entry
    with the value 0.0 (in a member's row range, not on a hot index)."""
    rng = np.random.default_rng(seed)
    hot = nnz * 6 // 10
    i0 = np.concatenate([rng.integers(0, 3, hot),
                         rng.integers(3, 1024, nnz - hot)])
    ind = np.stack([i0, rng.integers(0, 40, nnz), rng.integers(0, 40, nnz)],
                   axis=1).astype(np.int32)
    t = SparseTensor(ind, rng.standard_normal(nnz).astype(np.float32),
                     (1024, 40, 40)).deduplicated()
    if explicit_zero:
        vals = t.values.copy()
        vals[int(np.flatnonzero(t.indices[:, 0] == 700)[0])] = 0.0
        t = SparseTensor(t.indices, vals, t.shape)
    return t
