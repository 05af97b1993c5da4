"""AMPED tensor partitioning (paper §3): the port's copy of the planner.

A copy of the reference package's ``core/partition.py``, held array for
array and bitwise against it by the tests, so that the port plans without
importing the reference. The out-of-core plans of :mod:`repro_torch.store`
build on :func:`mode_layout`; the plan cache waits for its own slice of
the port.

For each output mode ``d`` the tensor is sharded so that **all nonzeros that
update the same output factor-matrix row live on the same device group** —
the paper's race-freedom invariant. Two structural changes serve the EC
kernels:

* **Sorted segments instead of atomics** — each device's nonzeros are ordered
  by output row and padded into fixed-size kernel blocks that never straddle
  an output row tile, so the elementwise computation (EC) becomes a dense
  per-tile accumulation rather than an atomic scatter.

* **Replication factor ``r``** — devices are viewed as ``n_groups × r``.
  Output rows are owned by *groups*; within a group the group's nonzeros are
  split equally across its ``r`` members and merged with an intra-group
  reduce-scatter. ``r=1`` is the paper's AMPED scheme.

Factor matrices are stored in **padded ownership layout**: mode ``w``'s factor
has ``n_groups_w * rows_max_w`` rows, row ``g*rows_max + k`` being the
``k``-th index owned by group ``g`` (zero rows for padding). Every tensor
copy stores its indices pre-translated into each mode's padded layout, so EC
is gather → multiply → segment-reduce.

The scheduling decisions — which group owns which index and which
replication factor to use — live in :mod:`repro_torch.schedule.static`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

import numpy as np

from repro_torch.core.coo import SparseTensor
from repro_torch.schedule import static as static_policies
from repro_torch.schedule.static import auto_replication  # noqa: F401  (re-export)

__all__ = [
    "ModeLayout",
    "ModePartition",
    "CPPlan",
    "mode_layout",
    "partition_mode",
    "build_plan",
    "block_device_rows",
    "block_segment_descriptors",
    "auto_replication",
    "validate_plan",
    "Strategy",
]

Strategy = Literal["amped_cdf", "amped_lpt", "uniform_index", "equal_nnz"]

# Block layouts. Both order each device's real nonzeros by output row (the
# row-sorted hierarchical-COO copy of SparseTensor.sorted_by_mode, localized
# per device); they differ only in where PAD slots point:
#   "blocked" — pads point at their tile's FIRST row (the one-hot kernels'
#               historical contract; rows within a block are NOT monotone).
#   "sorted"  — pads point at the LAST real row written so far, so
#               local_rows is globally nondecreasing per device and every
#               block holds at most `tile + 1` row segments. This is what
#               lets ec_sorted replace the one-hot scatter with a segmented
#               reduction.
# Pad values are 0 either way, so pads stay exact no-ops for every variant.
Layout = Literal["blocked", "sorted"]
DEFAULT_LAYOUT = "blocked"

# Output row tile height used by the EC kernels; rows_max is padded to a
# multiple of lcm(TILE, r) so both the kernel grid and the intra-group
# reduce-scatter divide evenly.
DEFAULT_TILE = 8
DEFAULT_BLOCK_P = 128


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclasses.dataclass(frozen=True)
class ModeLayout:
    """The histogram-only half of one mode's partition: which group owns
    each global index and the padded row layout. Everything here is
    computable from the mode's nnz histogram alone — no nonzero data — in
    O(index space). :func:`partition_mode` builds its device arrays on top
    of it."""

    mode: int
    num_devices: int
    r: int
    n_groups: int
    rows_max: int
    tile: int
    block_p: int
    owner: np.ndarray              # (I,) int32 owner group per global index
    global_to_padded: np.ndarray   # (I,) int64
    padded_to_global: np.ndarray   # (n_groups*rows_max,) int64, -1 pad
    rows_owned: np.ndarray         # (n_groups,) int64
    # pad-row placement, see Layout above
    block_layout: str = DEFAULT_LAYOUT

    @property
    def n_tiles(self) -> int:
        return self.rows_max // self.tile

    @property
    def padded_rows(self) -> int:
        return self.n_groups * self.rows_max


def mode_layout(
    hist: np.ndarray,
    mode: int,
    num_devices: int,
    *,
    strategy: Strategy = "amped_cdf",
    replication: int | None = None,
    tile: int | None = None,
    block_p: int | None = None,
    layout: Layout = DEFAULT_LAYOUT,
) -> ModeLayout:
    """Resolve one mode's partition layout from its nnz histogram only."""
    tile = DEFAULT_TILE if tile is None else tile
    block_p = DEFAULT_BLOCK_P if block_p is None else block_p
    if layout not in ("blocked", "sorted"):
        raise ValueError(f"unknown block layout {layout!r} "
                         f"(expected 'blocked' or 'sorted')")
    m = num_devices
    policy = static_policies.get_policy(strategy)
    forced_r = policy.replication(hist, m)
    if forced_r is not None:
        r = forced_r
    elif replication is None:
        r = auto_replication(hist, m)
    else:
        r = replication
    if m % r:
        raise ValueError(f"replication {r} must divide device count {m}")
    n_groups = m // r

    owner = _assign_groups(hist, n_groups, strategy)
    max_rows_owned = int(np.bincount(owner, minlength=n_groups).max()) if owner.size else 0
    unit = _lcm(tile, r)
    rows_max = max(unit, -(-max(max_rows_owned, 1) // unit) * unit)
    if rows_max % r:
        # Unreachable through the lcm padding above, but the invariant is
        # load-bearing for the exchange: a non-divisible rows_max would make
        # the intra-group reduce-scatter assign fractional row ownership.
        raise ValueError(
            f"mode {mode}: padded row count rows_max={rows_max} is not "
            f"divisible by replication r={r}; the intra-group merge would "
            f"corrupt row ownership")
    g2p, p2g, rows_owned = _layout_rows(owner, n_groups, rows_max)
    return ModeLayout(
        mode=mode, num_devices=m, r=r, n_groups=n_groups, rows_max=rows_max,
        tile=tile, block_p=block_p, owner=np.asarray(owner, np.int32),
        global_to_padded=g2p, padded_to_global=p2g, rows_owned=rows_owned,
        block_layout=layout)


@dataclasses.dataclass(frozen=True)
class ModePartition:
    """Device-ready sharding of one per-mode tensor copy.

    Stacked leading axis = device id ``g = group * r + sub``. All shapes are
    static and equal across devices (padding entries have ``values == 0`` and
    ``local_rows`` pointing at a row the device already owns, so they are
    exact no-ops).

    ``META_FIELDS`` are the scalar fields a lazy
    :class:`~repro_torch.store.StoreModePartition` shares with this class.
    """

    META_FIELDS = ("mode", "num_devices", "r", "n_groups", "rows_max",
                   "tile", "block_p", "block_layout")
    # The out-of-core counterpart (repro_torch.store.StoreModePartition)
    # flips this: lazy partitions defer indices/values/local_rows to
    # per-device streaming materialization and reject whole-array access.
    lazy = False

    mode: int
    num_devices: int
    r: int                      # intra-group replication (1 = paper scheme)
    n_groups: int
    rows_max: int               # padded rows per group (multiple of lcm(TILE, r))
    tile: int
    block_p: int
    # (m, nnz_max, N) int32 — input-gather indices, translated into each
    # mode's padded factor layout (column d holds the *global padded* output
    # row, for reference/debug; EC uses local_rows).
    indices: np.ndarray
    values: np.ndarray          # (m, nnz_max) f32, 0 for padding
    local_rows: np.ndarray      # (m, nnz_max) int32 in [0, rows_max)
    block_to_tile: np.ndarray   # (m, nblocks) int32 in [0, rows_max/TILE)
    tile_visited: np.ndarray    # (m, rows_max/TILE) f32 — 1 iff some block
                                # maps to the tile (kernel leaves unvisited
                                # output tiles uninitialised; they are masked)
    nnz_true: np.ndarray        # (m,) true (unpadded) nnz per device
    rows_owned: np.ndarray      # (n_groups,) true rows owned per group
    blocks_true: np.ndarray     # (m,) used (non-pad) kernel blocks per
                                # device — with block_p this is the work the
                                # kernel actually executes (the cost model's
                                # "slots" feature; trailing pad blocks are
                                # revisits of an already-done tile)
    block_layout: str = DEFAULT_LAYOUT  # pad placement ("blocked"|"sorted")

    @property
    def nnz_max(self) -> int:
        return int(self.values.shape[1])

    @property
    def nblocks(self) -> int:
        return int(self.block_to_tile.shape[1])

    @property
    def padded_rows(self) -> int:
        """Rows of the padded output factor = n_groups * rows_max."""
        return self.n_groups * self.rows_max

    def balance_stats(self) -> dict:
        t = self.nnz_true.astype(np.float64)
        return {
            "nnz_max": int(t.max()),
            "nnz_min": int(t.min()),
            "nnz_mean": float(t.mean()),
            "overhead": float((t.max() - t.min()) / max(t.max(), 1.0)),
            "padding_frac": float(1.0 - t.sum() / (self.nnz_max * self.num_devices)),
        }


@dataclasses.dataclass(frozen=True)
class CPPlan:
    """Preprocessing output: one partitioned copy per mode (paper §3.1),
    plus the global↔padded row translations for every mode."""

    shape: tuple[int, ...]
    num_devices: int
    modes: tuple[ModePartition, ...]
    global_to_padded: tuple[np.ndarray, ...]   # per mode: (I_w,) int32
    padded_to_global: tuple[np.ndarray, ...]   # per mode: (padded,) int32, -1 pad
    norm: float                                 # ||X||_F for ALS fit
    # Incremented by every applied schedule.rebalance decision
    # (schedule/rebalance.py), so a decision is never applied to a plan it
    # was not made for.
    rebalance_epoch: int = 0

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def padded_sizes(self) -> tuple[int, ...]:
        return tuple(m.padded_rows for m in self.modes)


def _assign_groups(
    hist: np.ndarray, n_groups: int, strategy: Strategy
) -> np.ndarray:
    """owner_group per index, via the named static policy
    (:mod:`repro_torch.schedule.static`). All policies keep the AMPED invariant
    (an index is owned by exactly one group)."""
    return static_policies.get_policy(strategy).assign(hist, n_groups)


def block_device_rows(lrow: np.ndarray, vals: np.ndarray, inds: np.ndarray,
                      *, n_tiles: int, tile: int, block_p: int,
                      layout: Layout = DEFAULT_LAYOUT):
    """Kernel-block one device's entries (the layout contract of
    kernels/ops.py): group row-sorted entries by output tile, pad each
    tile's run to a multiple of ``block_p`` (pad values 0 → exact no-ops),
    so no block straddles a tile. ``layout`` picks where pad slots point:
    the tile's first row (``"blocked"``) or the last real row already
    emitted (``"sorted"``, keeping ``rows_b`` nondecreasing).

    ``lrow``: (k,) local output rows in [0, n_tiles*tile); ``vals``: (k,)
    values; ``inds``: (k, N) index rows. Returns (rows_b, vals_b, inds_b,
    b2t_b) where the first three have ``sum(ceil(per_tile/block_p))*block_p``
    entries and ``b2t_b`` maps each block to its tile. Shared by
    :func:`partition_mode` and the incremental re-blocking of
    :mod:`repro_torch.schedule.rebalance`.
    """
    k = lrow.size
    nmodes = inds.shape[1] if inds.ndim == 2 else 0
    tiles = lrow // tile
    tc = np.bincount(tiles, minlength=n_tiles) if k else np.zeros(n_tiles, np.int64)
    tc_pad = -(-tc // block_p) * block_p
    tot = int(tc_pad.sum())
    rows_b = np.zeros(tot, np.int64)
    vals_b = np.zeros(tot, np.float32)
    inds_b = np.zeros((tot, nmodes), np.int64)
    b2t_b = np.zeros(tot // block_p, np.int64) if tot else np.zeros(0, np.int64)
    off = 0
    src = 0
    tile_order = np.argsort(tiles, kind="stable")
    for ti in range(n_tiles):
        c, cp = int(tc[ti]), int(tc_pad[ti])
        if cp == 0:
            continue
        pick = tile_order[src:src + c]
        src += c
        rows_b[off:off + c] = lrow[pick]
        if layout == "sorted":
            # cp > 0 implies c > 0 (tc_pad is 0 exactly when tc is), so the
            # last real row exists and the block stays row-monotone.
            rows_b[off + c:off + cp] = rows_b[off + c - 1]
        else:
            rows_b[off + c:off + cp] = ti * tile  # no-op pad rows in tile
        vals_b[off:off + c] = vals[pick]
        inds_b[off:off + c] = inds[pick]
        b2t_b[off // block_p:(off + cp) // block_p] = ti
        off += cp
    return rows_b, vals_b, inds_b, b2t_b


def block_segment_descriptors(local_rows: np.ndarray, *, tile: int,
                              block_p: int):
    """Per-block row-segment descriptors for the ``sorted`` EC kernel.

    ``local_rows`` is any ``(..., nblocks * block_p)`` local-row array
    following the block layout contract (each block maps to one output
    tile). Runs of equal row-in-tile become segments: returns
    ``(seg_starts, seg_rows)`` with shapes ``(..., nblocks, S + 1)`` and
    ``(..., nblocks, S)`` where ``S = tile + 1`` (a block holds at most
    ``tile`` distinct rows plus one pad run that may break monotonicity
    under the legacy blocked layout). ``seg_starts[..., b, s]`` is the
    in-block start of segment ``s``; segment ``s`` spans
    ``[seg_starts[s], seg_starts[s + 1])`` and unused slots hold
    ``block_p`` so trailing segments are empty. ``seg_rows`` holds each
    segment's row within the tile (unused slots 0).

    Derived on demand from ``local_rows`` — descriptors are never
    serialized into plans or window spills.
    """
    lr = np.asarray(local_rows)
    lead = lr.shape[:-1]
    if lr.shape[-1] % block_p:
        raise ValueError(
            f"local_rows last dim {lr.shape[-1]} is not a multiple of "
            f"block_p={block_p}")
    nblocks = lr.shape[-1] // block_p
    S = tile + 1
    rit = (lr.reshape(-1, block_p) % tile).astype(np.int32)
    nb = rit.shape[0]
    newseg = np.ones_like(rit, dtype=bool)
    newseg[:, 1:] = rit[:, 1:] != rit[:, :-1]
    nseg = newseg.sum(axis=1)
    if int(nseg.max(initial=0)) > S:
        raise ValueError(
            f"block layout violation: a block holds {int(nseg.max())} row "
            f"segments, more than tile + 1 = {S}; rows within a block must "
            f"be tile-local (see block_device_rows)")
    seg_id = np.cumsum(newseg, axis=1) - 1
    seg_starts = np.full((nb, S + 1), block_p, np.int32)
    seg_rows = np.zeros((nb, S), np.int32)
    b, p = np.nonzero(newseg)
    seg_starts[b, seg_id[b, p]] = p
    seg_rows[b, seg_id[b, p]] = rit[b, p]
    return (seg_starts.reshape(*lead, nblocks, S + 1),
            seg_rows.reshape(*lead, nblocks, S))


def _layout_rows(owner: np.ndarray, n_groups: int, rows_max: int):
    """Padded-layout row ids. Returns (global_to_padded, padded_to_global,
    rows_owned)."""
    n_idx = owner.size
    order = np.argsort(owner, kind="stable")        # group-major, index-minor
    rows_owned = np.bincount(owner, minlength=n_groups)
    start = np.zeros(n_groups, np.int64)
    start[1:] = np.cumsum(rows_owned)[:-1]
    rank_in_group = np.arange(n_idx) - start[owner[order]]
    g2p = np.empty(n_idx, np.int64)
    g2p[order] = owner[order].astype(np.int64) * rows_max + rank_in_group
    p2g = np.full(n_groups * rows_max, -1, np.int64)
    p2g[g2p] = np.arange(n_idx)
    return g2p.astype(np.int64), p2g, rows_owned.astype(np.int64)


def partition_mode(
    t: SparseTensor,
    mode: int,
    num_devices: int,
    *,
    strategy: Strategy = "amped_cdf",
    replication: int | None = None,
    tile: int | None = None,
    block_p: int | None = None,
    layout: Layout = DEFAULT_LAYOUT,
    all_g2p: Sequence[np.ndarray] | None = None,
) -> tuple[ModePartition, np.ndarray, np.ndarray]:
    """Partition one per-mode tensor copy.

    Returns (ModePartition, global_to_padded, padded_to_global) for ``mode``.
    ``tile``/``block_p`` default (None) to DEFAULT_TILE/DEFAULT_BLOCK_P.
    ``all_g2p``: translations for the *other* modes (already computed); if
    None, input-mode indices are left untranslated (identity) — callers
    normally go through :func:`build_plan`, which wires all modes.
    """
    hist = t.mode_histogram(mode)
    lay = mode_layout(hist, mode, num_devices, strategy=strategy,
                      replication=replication, tile=tile, block_p=block_p,
                      layout=layout)
    m, r, n_groups = lay.num_devices, lay.r, lay.n_groups
    tile, block_p, rows_max = lay.tile, lay.block_p, lay.rows_max
    owner, g2p, p2g, rows_owned = (lay.owner, lay.global_to_padded,
                                   lay.padded_to_global, lay.rows_owned)

    # --- per-nonzero placement -------------------------------------------
    out_idx = t.indices[:, mode]
    nz_group = owner[out_idx] if owner.size else np.zeros(t.nnz, np.int32)
    nz_padded_row = g2p[out_idx] if owner.size else np.zeros(t.nnz, np.int64)
    # sort nonzeros by (group, padded row) → contiguous group runs, row-sorted
    order = np.lexsort((nz_padded_row, nz_group))
    nz_group, nz_padded_row = nz_group[order], nz_padded_row[order]
    ind_sorted, val_sorted = t.indices[order], t.values[order]

    group_counts = np.bincount(nz_group, minlength=n_groups)
    group_start = np.zeros(n_groups, np.int64)
    group_start[1:] = np.cumsum(group_counts)[:-1]

    # split each group's run into r near-equal contiguous chunks (row-sorted)
    dev_lists_idx: list[np.ndarray] = []
    for g in range(n_groups):
        s, c = int(group_start[g]), int(group_counts[g])
        bounds = np.linspace(0, c, r + 1).astype(np.int64)
        for sub in range(r):
            dev_lists_idx.append(np.arange(s + bounds[sub], s + bounds[sub + 1]))

    nnz_true = np.array([len(x) for x in dev_lists_idx], np.int64)

    # --- kernel blocking: per device, pad each row-tile's nnz to a multiple
    # of block_p so no block straddles a tile; then pad devices to the global
    # max block count.
    n_tiles = rows_max // tile
    nmodes = t.nmodes
    dev_rows, dev_vals, dev_inds, dev_b2t = [], [], [], []
    for dev, sel in enumerate(dev_lists_idx):
        g = dev // r
        lrow = (nz_padded_row[sel] - g * rows_max).astype(np.int64)
        rows_b, vals_b, inds_b, b2t_b = block_device_rows(
            lrow, val_sorted[sel], ind_sorted[sel],
            n_tiles=n_tiles, tile=tile, block_p=block_p, layout=layout)
        dev_rows.append(rows_b)
        dev_vals.append(vals_b)
        dev_inds.append(inds_b)
        dev_b2t.append(b2t_b)

    nnz_cap = max(max((x.size for x in dev_rows), default=0), block_p)
    nnz_cap = -(-nnz_cap // block_p) * block_p
    nblocks = nnz_cap // block_p
    rows_arr = np.zeros((m, nnz_cap), np.int64)
    vals_arr = np.zeros((m, nnz_cap), np.float32)
    inds_arr = np.zeros((m, nnz_cap, nmodes), np.int64)
    b2t_arr = np.zeros((m, nblocks), np.int64)
    visited = np.zeros((m, n_tiles), np.float32)
    for dev in range(m):
        k = dev_rows[dev].size
        rows_arr[dev, :k] = dev_rows[dev]
        vals_arr[dev, :k] = dev_vals[dev]
        inds_arr[dev, :k] = dev_inds[dev]
        kb = dev_b2t[dev].size
        b2t_arr[dev, :kb] = dev_b2t[dev]
        # trailing pad blocks revisit the last used tile (no extra switches)
        b2t_arr[dev, kb:] = dev_b2t[dev][-1] if kb else 0
        # pad rows must be in the pad blocks' tile; the sorted layout keeps
        # them at the device's last real row so local_rows stays monotone
        if layout == "sorted":
            rows_arr[dev, k:] = dev_rows[dev][-1] if k else 0
        else:
            pad_tile = int(b2t_arr[dev, -1])
            rows_arr[dev, k:] = pad_tile * tile
        visited[dev, b2t_arr[dev]] = 1.0

    # translate input-mode indices into padded layouts
    if all_g2p is not None:
        for w in range(nmodes):
            if w == mode:
                inds_arr[:, :, w] = np.where(
                    vals_arr != 0, g2p[np.minimum(inds_arr[:, :, w], max(hist.size - 1, 0))], 0
                ) if hist.size else 0
            else:
                t_g2p = all_g2p[w]
                if t_g2p is not None and t_g2p.size:
                    inds_arr[:, :, w] = np.where(
                        vals_arr != 0,
                        t_g2p[np.minimum(inds_arr[:, :, w], t_g2p.size - 1)],
                        0,
                    )

    part = ModePartition(
        mode=mode,
        num_devices=m,
        r=r,
        n_groups=n_groups,
        rows_max=rows_max,
        tile=tile,
        block_p=block_p,
        indices=inds_arr.astype(np.int32),
        values=vals_arr,
        local_rows=rows_arr.astype(np.int32),
        block_to_tile=b2t_arr.astype(np.int32),
        tile_visited=visited,
        nnz_true=nnz_true,
        rows_owned=rows_owned,
        blocks_true=np.array([x.size for x in dev_b2t], np.int64),
        block_layout=layout,
    )
    return part, g2p, p2g


def validate_plan(plan: CPPlan) -> CPPlan:
    """Check the invariants the exchange relies on; raise a clear
    ``ValueError`` at plan time rather than corrupting factors at sweep
    time. Today's load-bearing invariant: every mode's padded row count
    must split evenly across its replication group (``rows_max % r == 0``),
    or the intra-group reduce-scatter would hand each member a fractional
    row range. The EC kernels add a second: on every device, the blocks of
    a tile form one run of consecutive blocks (pads revisit the last used
    tile), since each run's tile is written once, without atomics, by its
    one work item or by ``ec_combine`` over its items; a tile visited again
    after another would be written twice. Returns ``plan`` unchanged so it
    composes as a pass-through (``api.plan`` and ``api.compile`` both run
    it)."""
    for part in plan.modes:
        for dev, b2t in enumerate(part.block_to_tile):
            run_tiles = b2t[np.r_[True, b2t[1:] != b2t[:-1]]] if b2t.size \
                else b2t
            if np.unique(run_tiles).size != run_tiles.size:
                raise ValueError(
                    f"invalid plan: mode {part.mode} device {dev} visits a "
                    f"tile in more than one run of blocks; the EC kernels "
                    f"need each tile's blocks consecutive.")
        if part.r > 0 and part.rows_max % part.r:
            raise ValueError(
                f"invalid plan: mode {part.mode} has rows_max="
                f"{part.rows_max} not divisible by replication r={part.r}; "
                f"the intra-group merge would corrupt row ownership. "
                f"Rebuild the plan (core/partition.py pads rows_max to a "
                f"multiple of lcm(tile, r)).")
        if part.num_devices != part.n_groups * part.r:
            raise ValueError(
                f"invalid plan: mode {part.mode} device grid "
                f"{part.n_groups}x{part.r} does not cover "
                f"num_devices={part.num_devices}")
    return plan


def build_plan(
    t: SparseTensor,
    num_devices: int,
    *,
    strategy: Strategy = "amped_cdf",
    replication: int | None = None,
    tile: int | None = None,
    block_p: int | None = None,
    layout: Layout = DEFAULT_LAYOUT,
) -> CPPlan:
    """Full preprocessing (paper §3 + §5.7): every mode's copy, partitioned,
    row-relabelled, kernel-blocked and padded. Pure host/numpy.

    A single replication factor is used for every mode (the max of the
    per-mode auto picks) so one (group, sub) device mesh serves the whole
    decomposition."""
    n = t.nmodes
    if replication is None and strategy != "equal_nnz":
        replication = max(
            auto_replication(t.mode_histogram(d), num_devices)
            for d in range(n))
    # pass 1: row layouts per mode (needed to translate input indices)
    g2ps: list[np.ndarray] = []
    metas = []
    for d in range(n):
        _, g2p, p2g = partition_mode(
            t, d, num_devices, strategy=strategy, replication=replication,
            tile=tile, block_p=block_p, layout=layout, all_g2p=None)
        g2ps.append(g2p)
        metas.append(p2g)
    # pass 2: build device arrays with translated indices
    parts = []
    for d in range(n):
        part, _, _ = partition_mode(
            t, d, num_devices, strategy=strategy, replication=replication,
            tile=tile, block_p=block_p, layout=layout, all_g2p=g2ps)
        parts.append(part)
    return validate_plan(CPPlan(
        shape=t.shape,
        num_devices=num_devices,
        modes=tuple(parts),
        global_to_padded=tuple(g.astype(np.int32) for g in g2ps),
        padded_to_global=tuple(p.astype(np.int32) for p in metas),
        norm=t.norm(),
    ))
