"""Inputs shared by the port's tests (tests/test_torch_*.py).

numpy and repro_torch only — no jax — so the card's tests can use them on
a machine without jax. The grids and seeds are those of the reference's
tests/test_sorted_kernel.py and tests/test_kernels.py; the partitions come
from the port's planner, which test_torch_plan.py holds bitwise against the
reference's, so the JAX side of a parity test can take the same arrays.
"""
import numpy as np

from repro_torch.core.coo import SparseTensor, random_sparse
from repro_torch.core.partition import (block_segment_descriptors,
                                        partition_mode)

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


LONG_RUN = {
    "hot_row_3mode": lambda: hot_row_case(3, 8, seed=1),
    "hot_row_4mode": lambda: hot_row_case(4, 32, seed=2),
    "hot_row_5mode": lambda: hot_row_case(5, 8, seed=3),
    "hot_row_blocked_layout": lambda: hot_row_case(3, 32, seed=4,
                                                   layout="blocked"),
    "boundary_on_block_edge": long_block_edge_case,
    "all_padding_last_item": long_trailing_pad_case,
}


def shard_arrays(part, dev=0):
    """One device's EC inputs as numpy arrays, with the sorted variant's
    segment descriptors."""
    ss, sr = block_segment_descriptors(part.local_rows[dev], tile=part.tile,
                                       block_p=part.block_p)
    return dict(indices=part.indices[dev], values=part.values[dev],
                local_rows=part.local_rows[dev],
                block_to_tile=part.block_to_tile[dev],
                tile_visited=part.tile_visited[dev], seg_starts=ss,
                seg_rows=sr)


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
