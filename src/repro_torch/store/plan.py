"""Plan-from-stats: partition an out-of-core tensor without reading it.

The port's copy of the reference package's ``store/plan.py``, held array
for array against it by the tests.

The observation that makes this work: *everything* in a
:class:`~repro_torch.core.partition.ModePartition` except the per-nonzero payload
(``indices``/``values``) is a function of the mode's nnz **histogram** and
the layout derived from it. Which group owns an index, the padded row
layout, each device's true nnz, its per-tile entry counts — and therefore
the kernel blocking (``block_to_tile``, ``tile_visited``, ``blocks_true``,
the padded ``nnz_max``) and even the full ``local_rows`` array — all follow
from ``hist`` in O(index space). So:

* :func:`build_plan_from_store` builds a complete, validated
  :class:`~repro_torch.core.partition.CPPlan` from the store's manifest
  statistics alone — **zero chunk reads** (asserted in tests via
  ``store.access_stats``). Its modes are :class:`StoreModePartition`\\ s.

* :meth:`StoreModePartition.device_arrays` materializes ONE device's
  ``(indices, values, local_rows)`` by streaming only the chunks whose
  manifest index range overlaps the device's owned rows, scattering each
  nonzero straight into its final blocked slot. Because the in-memory path
  orders equal-row nonzeros by original position (stable lexsort) and the
  store preserves append order, the result is bit-identical to the
  corresponding slice of :func:`repro_torch.core.partition.partition_mode` —
  tested per device, per strategy.

Whole-array access (``part.values`` etc.) raises :class:`OutOfCoreError`
instead of silently materializing O(nnz) host memory; consumers that need
device data go through ``device_arrays``/``materialize`` explicitly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import partition as partition_mod
from repro_torch.core.partition import (CPPlan, ModeLayout, ModePartition,
                                        Strategy)
from repro_torch.schedule.static import auto_replication
from repro_torch.store.store import TensorStore

__all__ = ["OutOfCoreError", "StoreModePartition", "build_plan_from_store",
           "lazy_parts_from_layouts", "ModeStreamPlan",
           "split_mode_super_shards", "stream_shard_nbytes",
           "resident_shard_nbytes", "budget_slot_cap"]


class OutOfCoreError(RuntimeError):
    """Whole-tensor array access on an out-of-core partition."""


def _device_tile_counts(cum_g: np.ndarray, b0: int, b1: int, *,
                        n_tiles: int, tile: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-row and per-tile true entry counts of one device.

    ``cum_g`` is the group's inclusive-prefix row histogram (rows_max+1,)
    in padded-row order; the device owns ranks ``[b0, b1)`` of the group's
    row-sorted nonzero run (the ``np.linspace`` split of
    ``partition_mode``)."""
    cnt = np.minimum(cum_g[1:], b1) - np.maximum(cum_g[:-1], b0)
    np.clip(cnt, 0, None, out=cnt)
    tc = cnt.reshape(n_tiles, tile).sum(axis=1)
    return cnt, tc


class StoreModePartition:
    """Lazy, histogram-derived stand-in for one mode's
    :class:`~repro_torch.core.partition.ModePartition`, backed by a
    :class:`TensorStore`.

    Duck-compatible for every consumer that reads metadata and the cheap
    arrays (``block_to_tile``, ``tile_visited``, ``nnz_true``,
    ``rows_owned``, ``blocks_true`` — O(m · n_tiles)); the O(nnz) arrays
    are materialized per device on demand.
    """

    META_FIELDS = ModePartition.META_FIELDS
    lazy = True

    def __init__(self, store: TensorStore, layout: ModeLayout,
                 all_g2p: list[np.ndarray]):
        self.store = store
        self.layout = layout
        self.block_layout = layout.block_layout
        self.all_g2p = [np.asarray(g, np.int64) for g in all_g2p]
        self.mode = layout.mode
        self.num_devices = layout.num_devices
        self.r = layout.r
        self.n_groups = layout.n_groups
        self.rows_max = layout.rows_max
        self.tile = layout.tile
        self.block_p = layout.block_p
        self.rows_owned = layout.rows_owned

        hist = store.mode_histogram(self.mode)
        m, r, tile, block_p = (self.num_devices, self.r, self.tile,
                               self.block_p)
        n_tiles = layout.n_tiles
        # padded-row histogram: each owned global index contributes its nnz
        # at its padded row; pad rows stay 0
        rh = np.zeros(layout.padded_rows, np.int64)
        rh[layout.global_to_padded] = hist
        runs = rh.reshape(self.n_groups, self.rows_max)
        self._cum = np.zeros((self.n_groups, self.rows_max + 1), np.int64)
        np.cumsum(runs, axis=1, out=self._cum[:, 1:])
        # the linspace rank split partition_mode applies within each group
        self._bounds = np.stack([
            np.linspace(0, int(self._cum[g, -1]), r + 1).astype(np.int64)
            for g in range(self.n_groups)])

        nnz_true = np.zeros(m, np.int64)
        blocks_true = np.zeros(m, np.int64)
        dev_tc_pad: list[np.ndarray] = []
        for dev in range(m):
            g, s = dev // r, dev % r
            b0, b1 = int(self._bounds[g, s]), int(self._bounds[g, s + 1])
            _, tc = _device_tile_counts(self._cum[g], b0, b1,
                                        n_tiles=n_tiles, tile=tile)
            tc_pad = -(-tc // block_p) * block_p
            dev_tc_pad.append(tc_pad)
            nnz_true[dev] = b1 - b0
            blocks_true[dev] = int(tc_pad.sum()) // block_p
        # per-device per-tile PADDED slot counts — what the super-shard
        # splitter packs against a memory budget (O(m · n_tiles))
        self._dev_tc_pad = np.stack(dev_tc_pad)

        nnz_cap = max(int(max((tp.sum() for tp in dev_tc_pad), default=0)),
                      block_p)
        nnz_cap = -(-nnz_cap // block_p) * block_p
        self._nnz_max = nnz_cap
        nblocks = nnz_cap // block_p
        b2t = np.zeros((m, nblocks), np.int64)
        visited = np.zeros((m, n_tiles), np.float32)
        for dev in range(m):
            tc_pad = dev_tc_pad[dev]
            true_b2t = np.repeat(np.arange(n_tiles), tc_pad // block_p)
            kb = true_b2t.size
            b2t[dev, :kb] = true_b2t
            # trailing pad blocks revisit the last used tile (no switches)
            b2t[dev, kb:] = true_b2t[-1] if kb else 0
            visited[dev, b2t[dev]] = 1.0
        self.block_to_tile = b2t.astype(np.int32)
        self.tile_visited = visited
        self.nnz_true = nnz_true
        self.blocks_true = blocks_true
        # per-group owned global index range → chunk-skip window
        self._group_span = np.full((self.n_groups, 2), -1, np.int64)
        for g in range(self.n_groups):
            owned = np.flatnonzero(layout.owner == g)
            if owned.size:
                self._group_span[g] = (owned[0], owned[-1])

    # -- ModePartition-compatible metadata --------------------------------
    @property
    def nnz_max(self) -> int:
        return self._nnz_max

    @property
    def nblocks(self) -> int:
        return int(self.block_to_tile.shape[1])

    @property
    def padded_rows(self) -> int:
        return self.n_groups * self.rows_max

    @property
    def nmodes(self) -> int:
        return len(self.all_g2p)

    def balance_stats(self) -> dict:
        return ModePartition.balance_stats(self)

    # -- guarded whole-tensor access --------------------------------------
    def _out_of_core(self, field: str):
        raise OutOfCoreError(
            f"ModePartition.{field} would materialize the full "
            f"({self.num_devices}, {self.nnz_max}) array of an out-of-core "
            f"plan in host RAM; use device_arrays(dev) for one device's "
            f"slice, or materialize() if the tensor truly fits")

    @property
    def indices(self):
        self._out_of_core("indices")

    @property
    def values(self):
        self._out_of_core("values")

    @property
    def local_rows(self):
        self._out_of_core("local_rows")

    # -- per-device materialization ---------------------------------------
    def device_arrays(self, dev: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize one device's ``(indices, values, local_rows)`` —
        shapes ``(nnz_max, N) int32 / (nnz_max,) f32 / (nnz_max,) int32`` —
        by streaming only manifest-overlapping chunks. Bit-identical to the
        in-memory ``partition_mode`` arrays for this device.

        For replication r>1 every sub-device of a group re-streams the
        group's chunks (the rank cursors are group-level). That is a
        deliberate trade: a one-pass group materializer would hold all r
        sub-slices — at ``equal_nnz`` (r=m, one group) that is the whole
        tensor, exactly the bound this subsystem exists to keep. r is small
        in practice (the paper scheme is r=1), so the extra passes cost
        r× chunk I/O, not memory."""
        ind, val, rows, _, _ = self.super_shard_arrays(
            dev, 0, self.layout.n_tiles, nnz_cap=self._nnz_max,
            nblocks=self.nblocks)
        return ind, val, rows

    def super_shard_arrays(self, dev: int, t0: int, t1: int, *,
                           nnz_cap: int, nblocks: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray, np.ndarray]:
        """Materialize the tile window ``[t0, t1)`` of one device's shard:
        ``(indices, values, local_rows, block_to_tile, tile_visited)`` with
        static shapes ``(nnz_cap, N) / (nnz_cap,) / (nnz_cap,) /
        (nblocks,) / (n_tiles,)``.

        Super-shards split at TILE boundaries, so every block — and hence
        every output row — lives in exactly one window, with block order
        within a tile and slot order within a block unchanged from the
        resident shard. Accumulating the windows' masked EC partials into a
        zero accumulator is therefore bitwise identical to the resident
        single-call EC (see core.mttkrp.make_partial_mttkrp_fn). Row and
        tile ids stay ABSOLUTE (device-local padded layout); only the slot
        packing restarts at 0 per window. The full window
        ``(0, n_tiles)`` reproduces :meth:`device_arrays` exactly.

        Trailing capacity beyond the window's padded slots is pure padding
        (value 0, rows pointing at the window's last used tile), identical
        in kind to the resident shard's trailing pad blocks.
        """
        lay = self.layout
        m, r, tile, block_p = (self.num_devices, self.r, self.tile,
                               self.block_p)
        if not 0 <= dev < m:
            raise IndexError(f"device {dev} out of range [0, {m})")
        n_tiles = lay.n_tiles
        if not 0 <= t0 <= t1 <= n_tiles:
            raise ValueError(f"tile window [{t0}, {t1}) outside "
                             f"[0, {n_tiles}]")
        g, s = dev // r, dev % r
        cum_g = self._cum[g]
        b0, b1 = int(self._bounds[g, s]), int(self._bounds[g, s + 1])
        cnt_full, tc_full = _device_tile_counts(cum_g, b0, b1,
                                                n_tiles=n_tiles, tile=tile)
        tc = tc_full[t0:t1]
        tc_pad = -(-tc // block_p) * block_p
        w_tiles = t1 - t0
        r_lo, r_hi = t0 * tile, t1 * tile
        need = int(tc_pad.sum())
        if need > nnz_cap:
            raise ValueError(
                f"window [{t0}, {t1}) of device {dev} needs {need} slots "
                f"but nnz_cap={nnz_cap}")
        kb = need // block_p
        if kb > nblocks:
            raise ValueError(
                f"window [{t0}, {t1}) of device {dev} needs {kb} blocks "
                f"but nblocks={nblocks}")

        # blocking metadata: absolute tile ids, trailing pad blocks revisit
        # the window's last used tile (no switches) — tile 0 when empty,
        # matching the empty-device convention of the resident layout
        true_b2t = np.repeat(np.arange(t0, t1), tc_pad // block_p)
        b2t = np.zeros(nblocks, np.int64)
        b2t[:kb] = true_b2t
        b2t[kb:] = true_b2t[-1] if kb else 0
        visited = np.zeros(n_tiles, np.float32)
        visited[b2t] = 1.0

        # Dtype split: ranks/cursors (cum_g, seen, rank) stay int64 — they
        # count nonzeros and must survive billion-nnz tensors — while
        # anything bounded by this window's nnz_cap (slot positions, row
        # ids) is int32, halving the materializer's transient footprint.
        cnt32 = cnt_full[r_lo:r_hi].astype(np.int32)
        tile_off = np.zeros(w_tiles, np.int32)
        tile_off[1:] = np.cumsum(tc_pad[:-1], dtype=np.int64).astype(np.int32)
        cumcnt = np.zeros(w_tiles * tile + 1, np.int32)
        np.cumsum(cnt32, out=cumcnt[1:])
        # blocked slot where each window row's run starts (indexed by
        # row - r_lo)
        row_slot_start = (np.repeat(tile_off - cumcnt[:-1].reshape(
            w_tiles, tile)[:, 0], tile) + cumcnt[:-1]) if w_tiles else \
            np.zeros(0, np.int32)

        nmodes = self.nmodes
        # final dtypes from the start: the padded translations fit int32 by
        # construction, and the int64 intermediates would double this
        # function's peak (the bound the out-of-core path exists to keep)
        values = np.zeros(nnz_cap, np.float32)
        indices = np.zeros((nnz_cap, nmodes), np.int32)
        # local_rows analytically. Pad-row placement mirrors partition_mode:
        #   blocked — in-tile pads point at the tile's FIRST row, trailing
        #             slots at the last used tile's first row;
        #   sorted  — pads point at the LAST REAL row already emitted (the
        #             tile's last occupied row; trailing slots the last used
        #             tile's), keeping local_rows nondecreasing.
        pad_per_tile = (tc_pad - tc).astype(np.int32)
        pad_pos = (np.repeat(tile_off + tc.astype(np.int32), pad_per_tile)
                   + _ragged_arange(pad_per_tile))
        if self.block_layout == "sorted" and kb:
            cnt2d = cnt32.reshape(w_tiles, tile)
            # per-window-tile last occupied row-in-tile (-1 for empty tiles;
            # never indexed there: pad_per_tile > 0 implies tc > 0)
            last_rit = np.where(
                cnt2d > 0, np.arange(tile, dtype=np.int32)[None, :],
                np.int32(-1)).max(axis=1).astype(np.int32)
            lt = int(b2t[-1])  # last used tile (absolute id)
            local_rows = np.full(
                nnz_cap, lt * tile + int(last_rit[lt - t0]), np.int32)
            local_rows[pad_pos] = np.repeat(
                np.arange(t0, t1, dtype=np.int32) * tile + last_rit,
                pad_per_tile)
        else:
            local_rows = np.full(
                nnz_cap, int(b2t[-1]) * tile if nblocks else 0, np.int32)
            local_rows[pad_pos] = np.repeat(
                np.arange(t0, t1, dtype=np.int32) * tile, pad_per_tile)
        real_rows = np.repeat(np.arange(r_lo, r_hi, dtype=np.int32), cnt32)
        real_pos = np.repeat(row_slot_start, cnt32) + _ragged_arange(cnt32)
        local_rows[real_pos] = real_rows

        # stream: group-level arrival cursor per padded row reproduces the
        # stable lexsort rank; chunk skipping via the manifest index ranges,
        # restricted to the global ids the WINDOW's rows own. A chunk
        # holding any window row's nonzeros necessarily overlaps that id
        # range, and the per-row cursors only need arrivals of window rows
        # — so skipping non-overlapping chunks cannot desync a rank. The
        # same invariant lets each chunk be pre-filtered to its [glo, ghi]
        # candidates with one range compare BEFORE any gather: every
        # arrival at a window row carries a global id inside the window's
        # owned range, and arrivals elsewhere feed cursors this window
        # never reads. Unsorted stores can't skip whole chunks, so this
        # per-entry cut is what keeps an S-window sweep from paying S full
        # O(nnz log nnz) ranking passes.
        base = g * self.rows_max
        p2g = lay.padded_to_global[base + r_lo:base + r_hi]
        owned = p2g[p2g >= 0]
        if owned.size:
            glo, ghi = int(owned.min()), int(owned.max())
            w_rows = r_hi - r_lo
            seen = np.zeros(w_rows, np.int64)
            owner, g2p = lay.owner, lay.global_to_padded
            for k in self.store.chunks_overlapping(self.mode, glo, ghi):
                ind, val = self.store.read_chunk(k)
                gidx = ind[:, self.mode]
                cand = np.flatnonzero((gidx >= glo) & (gidx <= ghi))
                if cand.size:
                    cand = cand[owner[gidx[cand]] == g]
                if not cand.size:
                    del ind, val  # release chunk buffers before next read
                    continue
                lp = g2p[gidx[cand]] - base - r_lo
                inw = np.flatnonzero((lp >= 0) & (lp < w_rows))
                if not inw.size:
                    del ind, val
                    continue
                sel, lp = cand[inw], lp[inw]
                occ = _stable_occurrences(lp)
                rank = cum_g[lp + r_lo] + seen[lp] + occ
                seen += np.bincount(lp, minlength=w_rows)
                w = np.flatnonzero((rank >= b0) & (rank < b1))
                if not w.size:
                    del ind, val
                    continue
                lpw = lp[w]
                slot = (row_slot_start[lpw] + rank[w]
                        - np.maximum(cum_g[lpw + r_lo], b0))
                rows_sel = sel[w]
                vw = val[rows_sel]
                values[slot] = vw
                # translate into every mode's padded layout; exact-zero
                # values keep index 0, matching the in-memory
                # where(vals != 0, ...) padding convention
                nz = np.flatnonzero(vw != 0)
                snz = slot[nz]
                for col in range(nmodes):
                    indices[snz, col] = \
                        self.all_g2p[col][ind[rows_sel[nz], col]]
                # per-chunk release: a streamed sweep touches hundreds of
                # chunk-groups; holding these to loop end would stack them
                del ind, val
        return indices, values, local_rows, b2t.astype(np.int32), visited

    def materialize(self) -> ModePartition:
        """Assemble the full in-memory :class:`ModePartition` (O(nnz) host
        RAM — small tensors and tests only)."""
        m = self.num_devices
        inds = np.zeros((m, self.nnz_max, self.nmodes), np.int32)
        vals = np.zeros((m, self.nnz_max), np.float32)
        rows = np.zeros((m, self.nnz_max), np.int32)
        for dev in range(m):
            inds[dev], vals[dev], rows[dev] = self.device_arrays(dev)
        return ModePartition(
            mode=self.mode, num_devices=m, r=self.r, n_groups=self.n_groups,
            rows_max=self.rows_max, tile=self.tile, block_p=self.block_p,
            indices=inds, values=vals, local_rows=rows,
            block_to_tile=self.block_to_tile,
            tile_visited=self.tile_visited, nnz_true=self.nnz_true,
            rows_owned=self.rows_owned, blocks_true=self.blocks_true,
            block_layout=self.block_layout)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated — per-segment arange (int32:
    totals here are slot positions, bounded by nnz_max)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int32)
    starts = np.zeros(counts.size, np.int32)
    starts[1:] = np.cumsum(counts[:-1], dtype=np.int64).astype(np.int32)
    return np.arange(total, dtype=np.int32) - np.repeat(starts, counts)


def _stable_occurrences(keys: np.ndarray) -> np.ndarray:
    """For each element, how many equal keys precede it within the batch
    (stable, input order)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    is_start = np.ones(sk.size, bool)
    is_start[1:] = sk[1:] != sk[:-1]
    run_id = np.cumsum(is_start) - 1
    run_starts = np.flatnonzero(is_start)
    occ = np.empty(keys.size, np.int64)
    occ[order] = np.arange(keys.size, dtype=np.int64) - run_starts[run_id]
    return occ


# -- epoch streaming: budget-sized super-shards ------------------------------

@dataclasses.dataclass(frozen=True)
class ModeStreamPlan:
    """How one mode's sweep streams through device memory.

    ``windows[dev][k]`` is the half-open tile window ``(t0, t1)`` of device
    ``dev``'s k-th super-shard; devices with fewer super-shards than
    ``num_shards`` are padded with empty ``(0, 0)`` windows (pure padding
    shards — exact no-ops under the tile mask). All super-shards of a mode
    share one static shape (``nnz_cap`` slots, ``nblocks`` blocks), as in
    the reference, where that lets its jitted partial-MTTKRP compile once
    per mode.
    """

    mode: int
    num_shards: int                # sweep steps (max super-shards over devs)
    windows: tuple[tuple[tuple[int, int], ...], ...]   # [dev][k] -> (t0, t1)
    nnz_cap: int                   # slots per super-shard (mult. of block_p)
    nblocks: int                   # blocks per super-shard
    n_tiles: int
    shard_bytes: int               # device bytes of one super-shard
    budget_bytes: int              # the per-device budget it was split for
    buffers: int                   # concurrently resident super-shards

    def resident_bound_bytes(self) -> int:
        """Peak streamed bytes a device can hold under this plan."""
        return self.buffers * self.shard_bytes

    def validate_against(self, part, *, nmodes: int) -> list[str]:
        """Invariant check of this split against its source partition —
        the byte model and window algebra rule AP-P007
        (the reference's ``repro.analysis.plan_rules``) reports on. Returns violation
        messages (empty == consistent): the shard byte model must match
        :func:`stream_shard_nbytes`, ``buffers`` shards must fit the
        budget, every device's real windows must tile-disjointly cover
        ``[0, n_tiles)`` with padding windows ``(0, 0)`` only, and no
        window's padded slot count may exceed ``nnz_cap``."""
        out: list[str] = []
        model = stream_shard_nbytes(self.nnz_cap, self.nblocks,
                                    self.n_tiles, nmodes)
        if self.shard_bytes != model:
            out.append(f"shard_bytes={self.shard_bytes} != byte model "
                       f"{model} (nnz_cap={self.nnz_cap} "
                       f"nblocks={self.nblocks} n_tiles={self.n_tiles} "
                       f"nmodes={nmodes})")
        if self.resident_bound_bytes() > self.budget_bytes:
            out.append(f"{self.buffers} resident super-shards x "
                       f"{self.shard_bytes} B = "
                       f"{self.resident_bound_bytes()} B exceed the "
                       f"budget {self.budget_bytes} B")
        if self.nnz_cap % max(part.block_p, 1) or \
                self.nnz_cap != self.nblocks * part.block_p:
            out.append(f"nnz_cap={self.nnz_cap} is not nblocks="
                       f"{self.nblocks} whole blocks of block_p="
                       f"{part.block_p}")
        tc_pad = np.asarray(part._dev_tc_pad)
        for dev, wins in enumerate(self.windows):
            cursor, padding = 0, False
            for k, (t0, t1) in enumerate(wins):
                if (t0, t1) == (0, 0) and cursor > 0:
                    padding = True
                    continue
                if padding:
                    out.append(f"dev {dev}: real window {k} after "
                               f"padding windows")
                    break
                if t0 != cursor or t1 <= t0 or t1 > self.n_tiles:
                    out.append(f"dev {dev}: window {k} = ({t0}, {t1}) "
                               f"does not continue coverage at tile "
                               f"{cursor}")
                    break
                need = int(tc_pad[dev, t0:t1].sum())
                if need > self.nnz_cap:
                    out.append(f"dev {dev}: window ({t0}, {t1}) holds "
                               f"{need} padded slots > nnz_cap="
                               f"{self.nnz_cap} — the densest-tile floor "
                               f"is violated")
                cursor = t1
            else:
                if cursor != self.n_tiles and not (cursor == 0
                                                   and not wins):
                    out.append(f"dev {dev}: windows cover tiles "
                               f"[0, {cursor}) of [0, {self.n_tiles})")
        return out


def stream_shard_nbytes(nnz_cap: int, nblocks: int, n_tiles: int,
                        nmodes: int) -> int:
    """Device bytes of one super-shard's streamed arrays: int32 indices ×
    nmodes + f32 values + int32 local_rows per slot, int32 block_to_tile
    per block, f32 tile_visited per tile."""
    return nnz_cap * (4 * nmodes + 8) + nblocks * 4 + n_tiles * 4


def resident_shard_nbytes(part, nmodes: int) -> int:
    """Per-device bytes of one mode's RESIDENT shard arrays — the baseline
    a streaming budget is compared against (a tensor's "total shard bytes"
    is this summed over modes). Works for in-memory and lazy partitions."""
    n_tiles = int(part.tile_visited.shape[-1])
    return stream_shard_nbytes(part.nnz_max, part.nblocks, n_tiles, nmodes)


def budget_slot_cap(budget_bytes: int, *, nmodes: int, n_tiles: int,
                    block_p: int, buffers: int = 2) -> int:
    """Kernel slots one super-shard may hold under a per-device memory
    budget shared by ``buffers`` concurrently-resident shards, floored to a
    whole number of ``block_p`` blocks (0 if the fixed tile mask alone
    overflows). Inverse of :func:`stream_shard_nbytes`; also the member-nnz
    cap streaming-aware rebalancing clamps migrations to."""
    per_shard = budget_bytes // buffers
    # bytes a slot costs including its share of block_to_tile, after the
    # fixed tile_visited vector
    fixed = n_tiles * 4
    per_slot = 4 * nmodes + 8 + 4 / block_p
    cap = int((per_shard - fixed) // per_slot) if per_shard > fixed else 0
    return (cap // block_p) * block_p


def split_mode_super_shards(part: StoreModePartition, budget_bytes: int, *,
                            buffers: int = 2) -> ModeStreamPlan:
    """Split every device's shard into super-shards fitting a per-device
    memory budget — from the manifest-derived tile histograms alone, zero
    chunk reads.

    With ``buffers`` super-shards concurrently resident (2 = double
    buffering: shard k+1 transfers while k computes), each super-shard gets
    ``budget_bytes // buffers``. Windows split at tile boundaries only —
    the invariant that makes streamed accumulation bitwise identical to the
    resident path — so the densest single tile bounds the smallest feasible
    budget, and a budget below one store chunk's staging bytes is rejected
    outright (materializing any super-shard stages at least one chunk in
    host RAM).
    """
    if buffers < 1:
        raise ValueError("buffers must be >= 1")
    if budget_bytes < 1:
        raise ValueError("budget_bytes must be positive")
    lay = part.layout
    n_tiles, block_p, nmodes = lay.n_tiles, part.block_p, part.nmodes
    m = part.num_devices
    chunk_bytes = part.store.chunk_nnz * (8 * nmodes + 4)
    if budget_bytes < chunk_bytes:
        raise ValueError(
            f"memory budget {budget_bytes} B is smaller than one store "
            f"chunk's staging footprint ({part.store.chunk_nnz} nnz × "
            f"{8 * nmodes + 4} B = {chunk_bytes} B): materializing any "
            f"super-shard reads at least one chunk. Raise the budget or "
            f"re-ingest the store with a smaller chunk_nnz")
    slot_cap = budget_slot_cap(budget_bytes, nmodes=nmodes, n_tiles=n_tiles,
                               block_p=block_p, buffers=buffers)
    fixed = n_tiles * 4
    per_slot = 4 * nmodes + 8 + 4 / block_p
    dense_tile = int(part._dev_tc_pad.max()) if part._dev_tc_pad.size else 0
    min_slots = max(dense_tile, block_p)
    if slot_cap < min_slots:
        min_budget = buffers * int(min_slots * per_slot + fixed + 1)
        raise ValueError(
            f"memory budget {budget_bytes} B cannot hold mode "
            f"{part.mode}'s densest row tile ({dense_tile} padded slots; "
            f"super-shards split at tile boundaries): need at least "
            f"~{min_budget} B for {buffers}-buffered streaming, or re-plan "
            f"with a smaller tile")
    windows: list[list[tuple[int, int]]] = []
    # The reference wraps this loop in its tracer's "super_shard_split"
    # span; the port's span tracer is a later slice (ROADMAP, queue 1,
    # "Observability and tracing").
    for dev in range(m):
        tc_pad = part._dev_tc_pad[dev]
        wins: list[tuple[int, int]] = []
        t0, acc = 0, 0
        for t in range(n_tiles):
            c = int(tc_pad[t])
            if acc + c > slot_cap and acc > 0:
                wins.append((t0, t))
                t0, acc = t, 0
            acc += c
        wins.append((t0, n_tiles))
        windows.append(wins)
    num_shards = max(len(w) for w in windows)
    for wins in windows:
        wins.extend([(0, 0)] * (num_shards - len(wins)))
    nnz_cap = max(
        (int(part._dev_tc_pad[dev, t0:t1].sum())
         for dev in range(m) for t0, t1 in windows[dev]),
        default=0)
    nnz_cap = max(nnz_cap, block_p)
    nblocks = nnz_cap // block_p
    return ModeStreamPlan(
        mode=part.mode, num_shards=num_shards,
        windows=tuple(tuple(w) for w in windows),
        nnz_cap=nnz_cap, nblocks=nblocks, n_tiles=n_tiles,
        shard_bytes=stream_shard_nbytes(nnz_cap, nblocks, n_tiles, nmodes),
        budget_bytes=budget_bytes, buffers=buffers)


def lazy_parts_from_layouts(store: TensorStore, layouts: list[ModeLayout]
                            ) -> tuple[StoreModePartition, ...]:
    """Build every mode's lazy partition, wiring each one with all modes'
    padded-row translations (the cross-mode index translation of
    ``partition_mode``)."""
    g2ps = [lay.global_to_padded for lay in layouts]
    return tuple(StoreModePartition(store, lay, g2ps) for lay in layouts)


def build_plan_from_store(
    store: TensorStore,
    num_devices: int,
    *,
    strategy: Strategy = "amped_cdf",
    replication: int | None = None,
    tile: int | None = None,
    block_p: int | None = None,
    layout: partition_mod.Layout = partition_mod.DEFAULT_LAYOUT,
) -> CPPlan:
    """Full preprocessing of an out-of-core tensor from manifest stats.

    The structural twin of :func:`repro_torch.core.partition.build_plan`: same
    replication pick (max of the per-mode auto picks), same per-mode
    layouts — but O(index space) host memory and **zero chunk reads**; the
    O(nnz) device arrays stay behind
    :meth:`StoreModePartition.device_arrays`."""
    n = store.nmodes
    hists = [store.mode_histogram(d) for d in range(n)]
    if replication is None and strategy != "equal_nnz":
        replication = max(auto_replication(hists[d], num_devices)
                          for d in range(n))
    layouts = [partition_mod.mode_layout(
        hists[d], d, num_devices, strategy=strategy,
        replication=replication, tile=tile, block_p=block_p, layout=layout)
        for d in range(n)]
    for lay in layouts:
        # The device-side layout (ModePartition.indices, the exchange's row
        # translations) is int32 end to end; a padded row id beyond int32
        # would wrap silently in the casts below. The store format itself
        # goes to <u8, so fail loudly at plan time rather than corrupt.
        if lay.padded_rows > np.iinfo(np.int32).max:
            raise ValueError(
                f"mode {lay.mode}: padded row count {lay.padded_rows} "
                f"exceeds the int32 device index layout; shard over more "
                f"groups (fewer rows per group) — per-mode sizes beyond "
                f"2^31 are not yet supported by the device layout")
    parts = lazy_parts_from_layouts(store, layouts)
    return partition_mod.validate_plan(CPPlan(
        shape=store.shape,
        num_devices=num_devices,
        modes=parts,
        global_to_padded=tuple(
            lay.global_to_padded.astype(np.int32) for lay in layouts),
        padded_to_global=tuple(
            lay.padded_to_global.astype(np.int32) for lay in layouts),
        norm=store.norm(),
    ))
