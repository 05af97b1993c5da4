"""Telemetry-driven dynamic load rebalancing (the paper's second leg, §1/§4).

The port of the reference package's ``schedule/rebalance.py``; its numpy
half (migration planning and the incremental apply) is a copy, held bitwise
against the reference by the tests.

Static partitioning fixes *ownership* (which group updates which output
rows); what it cannot fix is mispredicted per-member cost inside a
replication group: the group's nonzeros are split into ``r`` equal-nnz
contiguous chunks, but the blocked layout's per-tile padding makes a
scattered chunk execute far more kernel slots than a hot-row chunk of the
same nnz. This module closes the loop:

  1. **Telemetry** — at rebalance points (never inside a sweep) each logical
     device's EC is timed on its *block-trimmed* shard: the first
     ``blocks_true`` kernel blocks, i.e. exactly the work that device
     executes. Devices are timed one after another and the parallel
     makespan is their max, so the probe means the same whether the logical
     devices share one card or have one each. Times are EWMA-smoothed
     across rebalance points.
  2. **Calibration** — the measured (features, times) pairs re-fit the
     linear cost model (:class:`repro_torch.schedule.cost.EwmaCostModel`),
     so the modelled-vs-measured gap is observable (``launch.decompose``
     reports it).
  3. **Migration** — when a mode's EWMA max/mean imbalance exceeds the
     threshold, nonzeros move between *members of the same group*
     (ownership never changes: member partials are summed by the
     intra-group reduce-scatter whichever member holds an entry). Moves are
     block-granular (multiples of ``block_p``), capped by the migration
     budget, and must fit inside the existing ``nnz_max`` padding headroom,
     so **no device array changes shape**.
  4. **Incremental replan** — :func:`apply_rebalance` re-sorts and re-pads
     only the migrated members' rows (reusing
     :func:`repro_torch.core.partition.block_device_rows`) and bumps the
     plan's ``rebalance_epoch``.

Modes partitioned with ``r == 1`` (the paper's pure AMPED scheme) have
single-member groups and are never migrated.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.obs import clock
from repro_torch.obs import trace as obs_trace
from repro_torch.schedule import cost as cost_mod

__all__ = ["GroupMigration", "ReplanDecision", "Rebalancer",
           "measure_mode_device_times", "trimmed_device_args",
           "plan_group_migrations", "apply_rebalance", "imbalance_ratio"]

_EPS = 1e-12


def imbalance_ratio(times: np.ndarray) -> float:
    """max/mean per-device time — 1.0 is perfect balance; the idle fraction
    of the parallel makespan is ``1 - 1/ratio``."""
    t = np.asarray(times, np.float64)
    mean = float(t.mean()) if t.size else 0.0
    return float(t.max() / mean) if mean > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class GroupMigration:
    """Intent to re-split one group's nonzeros among its r members."""

    mode: int
    group: int
    nnz_before: tuple[int, ...]   # per member, current real nnz
    nnz_target: tuple[int, ...]   # per member, block-granular, same total
    moved_nnz: int                # sum of positive deltas


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """Outcome of one rebalance point. ``triggered`` decisions are applied
    with :func:`apply_rebalance`; untriggered ones only carry telemetry."""

    epoch: int                          # plan epoch this decision applies to
    sweep: int                          # solver sweep at the rebalance point
    triggered: bool
    imbalance: dict                     # mode -> EWMA measured max/mean
    modelled_imbalance: dict            # mode -> cost-model-predicted ratio
    migrations: tuple[GroupMigration, ...]
    notes: tuple[str, ...] = ()

    @property
    def modes(self) -> list[int]:
        return sorted({m.mode for m in self.migrations})


# -- telemetry ---------------------------------------------------------------

def trimmed_device_args(part, arrays, dev: int) -> dict:
    """Device ``dev``'s placed shard of one mode (``arrays``, the
    :class:`~repro_torch.core.mttkrp.DeviceArrays` that
    ``place_shard`` put on the device) cut to its used kernel blocks —
    the work it actually executes (trailing global-pad blocks are no-op
    revisits) — keyed by ``kops.mttkrp_local``'s argument names. The cuts
    are views: nothing is copied or recomputed. The ``sorted`` variant's
    segment descriptors are per block, so the first ``blocks_true`` rows
    of the placed ones are the trimmed rows' own (the reference's
    ``_trimmed_device_args`` passes none, so its probe raises for that
    variant). The work items are not a view: trimming shortens the last
    run, which can make a split run whole, so the trimmed
    ``block_to_tile``'s own items are packed here, on its device, once per
    call and before any timing."""
    kb = max(int(part.blocks_true[dev]), 1)
    n = kb * part.block_p
    b2t = arrays.block_to_tile[:kb]
    return {"indices": arrays.indices[:n], "values": arrays.values[:n],
            "local_rows": arrays.local_rows[:n], "block_to_tile": b2t,
            "seg_starts": arrays.seg_starts[:kb],
            "seg_rows": arrays.seg_rows[:kb],
            "items": _build.pack_items(b2t)}


def _best_seconds(run, device: torch.device, repeats: int) -> float:
    """Best of ``repeats`` timed calls of ``run`` after one warm-up: CUDA
    events on ``device``'s current stream with ``device`` current, or the
    host clock on the CPU (where ``run`` is synchronous)."""
    best = float("inf")
    if device.type == "cuda":
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            run()
            for _ in range(max(1, repeats)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                run()
                end.record(stream)
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
        return best
    run()
    for _ in range(max(1, repeats)):
        t0 = clock.now()
        run()
        best = min(best, clock.now() - t0)
    return best


def measure_mode_device_times(part, factors: Sequence[Sequence[torch.Tensor]],
                              kernel_kw: dict | None = None, *,
                              arrays: Sequence, repeats: int = 1
                              ) -> np.ndarray:
    """Per-device EC time for one mode, (m,) seconds.

    ``factors[w][k]`` is logical device ``k``'s replica of mode ``w``'s
    padded factor (a solver's ``state.factors``) and ``arrays[k]`` its
    placed shard of ``part`` (a solver's ``dev_arrays[mode][k]``, on the
    same device); device ``k``'s trimmed shard
    (:func:`trimmed_device_args`) runs ``kops.mttkrp_local`` with
    ``kernel_kw`` (best of ``repeats`` after one warm-up). Devices are
    timed one after another. Each device's probe ends in a synchronise, so
    callers invoke it only at rebalance points. Nothing of ``factors`` or
    ``arrays`` is written. Each device's probe is one
    ``rebalance_probe`` span.
    """
    kernel_kw = dict(kernel_kw or {"use_kernel": False, "variant": "ref",
                                   "num_buffers": 2})
    times = np.zeros(part.num_devices, np.float64)
    for dev in range(part.num_devices):
        facs = [f[dev] for f in factors]
        a = trimmed_device_args(part, arrays[dev], dev)

        def run():
            return kops.mttkrp_local(
                factors=facs, mode=part.mode, num_rows=part.rows_max,
                tile=part.tile, block_p=part.block_p, **a, **kernel_kw)

        with obs_trace.span("rebalance_probe", mode=part.mode, device=dev,
                            annotate=True):
            times[dev] = _best_seconds(run, facs[0].device, repeats)
    return times


# -- migration planning ------------------------------------------------------

def plan_group_migrations(part, times: np.ndarray, *,
                          migration_budget: float,
                          max_member_nnz: int | None = None
                          ) -> list[GroupMigration]:
    """Convert one mode's measured member times into block-granular nnz
    re-splits, one :class:`GroupMigration` per group that should move work.

    Each member's throughput is estimated as ``nnz / time``; target nnz is
    proportional to throughput (equalizing predicted time), blended toward
    the current split so no more than ``migration_budget`` of the group's
    nonzeros move in one event, then rounded to whole ``block_p`` blocks.

    ``max_member_nnz`` is the epoch-streaming budget clamp: no member's
    target may exceed it (floored to a block multiple). Overflow is
    redistributed to members with headroom; a group whose total headroom
    cannot absorb it keeps its current split. The clamp bounds *true* nnz;
    :func:`apply_rebalance`'s ``nnz_max`` headroom check stays the hard
    shape guarantee.
    """
    out: list[GroupMigration] = []
    r, p = part.r, part.block_p
    if r <= 1 or migration_budget <= 0:
        return out
    for g in range(part.n_groups):
        sl = slice(g * r, (g + 1) * r)
        n = np.asarray(part.nnz_true[sl], np.float64)
        t = np.maximum(np.asarray(times[sl], np.float64), _EPS)
        total = n.sum()
        if total < 2 * p:            # too small to move a whole block
            continue
        speed = np.where(n > 0, n / t, 0.0)
        if not (speed > 0).any():
            continue
        speed = np.where(speed > 0, speed, speed[speed > 0].mean())
        delta = total * speed / speed.sum() - n
        moved = delta[delta > 0].sum()
        if moved <= 0:
            continue
        blend = min(1.0, migration_budget * total / moved)
        dlt = np.round(blend * delta / p) * p
        # re-zero-sum after rounding, then clamp targets at 0 (re-zeroing
        # again); bounded loops — each step moves one block.
        for _ in range(8 * r):
            k = int(round(dlt.sum() / p))
            if k == 0:
                break
            j = int(np.argmax(dlt)) if k > 0 else int(np.argmin(dlt))
            dlt[j] -= np.sign(k) * p
        target = n + dlt
        for _ in range(8 * r):
            neg = target < 0
            if not neg.any():
                break
            j = int(np.argmin(target))
            target[j] += p
            target[int(np.argmax(target))] -= p
        if max_member_nnz is not None:
            cap = (int(max_member_nnz) // p) * p
            excess = np.maximum(target - cap, 0.0)
            if excess.sum() > 0:
                head = np.maximum(cap - target, 0.0)
                if head.sum() < excess.sum():
                    continue     # budget cannot absorb the overflow anywhere
                target = np.minimum(target, cap)
                rem = excess.sum()
                for j in np.argsort(-head):
                    take = min(rem, head[j])   # block multiples throughout
                    target[j] += take
                    rem -= take
                    if rem <= 0:
                        break
        if (target < 0).any() or np.array_equal(target, n):
            continue
        out.append(GroupMigration(
            mode=int(part.mode), group=g,
            nnz_before=tuple(int(x) for x in n),
            nnz_target=tuple(int(x) for x in target),
            moved_nnz=int(np.maximum(target - n, 0).sum())))
    return out


# -- incremental replan ------------------------------------------------------

def _reblock_member(lrow, vals, inds, part):
    # imported here: core.partition imports the schedule package
    from repro_torch.core.partition import block_device_rows
    return block_device_rows(lrow, vals, inds,
                             n_tiles=part.rows_max // part.tile,
                             tile=part.tile, block_p=part.block_p,
                             layout=getattr(part, "block_layout", "blocked"))


def apply_rebalance(plan, decision: ReplanDecision):
    """Apply a triggered decision incrementally: only migrated members are
    re-sorted/re-padded; every array keeps its shape (migrations that would
    overflow a member's ``nnz_max`` headroom are geometrically shrunk toward
    the current split, and skipped if even one block cannot fit).

    Returns ``(new_plan, applied)`` where ``applied`` is a list of dicts
    (one per attempted migration) recording what actually moved. The new
    plan's ``rebalance_epoch`` is incremented even if every migration was
    skipped, so the decision is never re-applied to a stale plan.
    """
    if decision.epoch != plan.rebalance_epoch:
        raise ValueError(
            f"decision was made for plan epoch {decision.epoch}, but the "
            f"plan is at epoch {plan.rebalance_epoch}")
    new_modes = list(plan.modes)
    applied: list[dict] = []
    by_mode: dict[int, list[GroupMigration]] = {}
    for mig in decision.migrations:
        by_mode.setdefault(mig.mode, []).append(mig)

    for mode, migs in sorted(by_mode.items()):
        part = new_modes[mode]
        inds = np.array(part.indices)
        vals = np.array(part.values)
        rows = np.array(part.local_rows)
        b2t = np.array(part.block_to_tile)
        visited = np.array(part.tile_visited)
        nnz_true = np.array(part.nnz_true)
        blocks_true = np.array(part.blocks_true)
        r = part.r
        for mig in migs:
            devs = list(range(mig.group * r, (mig.group + 1) * r))
            # Real entries, member-major: each member stores a contiguous
            # row-sorted chunk (tiles ascending, rows sorted within a tile),
            # so concatenation restores the group's row-sorted run.
            masks = [vals[d] != 0 for d in devs]
            lrow = np.concatenate([rows[d][m] for d, m in zip(devs, masks)])
            v = np.concatenate([vals[d][m] for d, m in zip(devs, masks)])
            ix = np.concatenate([inds[d][m] for d, m in zip(devs, masks)])
            order = np.argsort(lrow, kind="stable")
            lrow, v, ix = lrow[order], v[order], ix[order]
            cur = np.array([int(m.sum()) for m in masks], np.int64)
            delta = (np.asarray(mig.nnz_target, np.int64)
                     - np.asarray(mig.nnz_before, np.int64))
            target = cur + delta
            # `vals != 0` is the padding convention, but a genuine entry
            # whose *stored value* is exactly 0.0 (cancelling duplicates in
            # deduplicated(), explicit zeros in a .tns file) is invisible to
            # it: the mask count then disagrees with the decision's
            # nnz_before bookkeeping. Rebuilding from the mask would
            # silently drop that entry — skip the group instead.
            if not np.array_equal(cur, np.asarray(mig.nnz_before, np.int64)) \
                    or (target < 0).any():
                applied.append({"mode": mode, "group": mig.group,
                                "moved_nnz": 0, "skipped": "stale-counts"})
                continue
            # shrink toward the current split until every member fits the
            # existing nnz_max headroom (current split always fits).
            blocked = None
            for attempt in range(6):
                bounds = np.concatenate([[0], np.cumsum(target)])
                trial = [
                    _reblock_member(lrow[bounds[s]:bounds[s + 1]],
                                    v[bounds[s]:bounds[s + 1]],
                                    ix[bounds[s]:bounds[s + 1]], part)
                    for s in range(r)]
                if all(tb[0].size <= part.nnz_max for tb in trial):
                    blocked = trial
                    break
                step = (target - cur) // 2
                step = (step // part.block_p) * part.block_p
                shrunk = cur + step - _rebalance_residual(step, part.block_p)
                target = cur if (shrunk < 0).any() else shrunk
            if blocked is None or (target == cur).all():
                applied.append({"mode": mode, "group": mig.group,
                                "moved_nnz": 0, "skipped": "no-headroom"})
                continue
            for s, dev in enumerate(devs):
                rows_b, vals_b, inds_b, b2t_b = blocked[s]
                k, kb = rows_b.size, b2t_b.size
                vals[dev][:] = 0
                inds[dev][:] = 0
                vals[dev][:k] = vals_b
                inds[dev][:k] = inds_b
                b2t[dev][:kb] = b2t_b
                b2t[dev][kb:] = b2t_b[-1] if kb else 0
                rows[dev][:k] = rows_b
                if getattr(part, "block_layout", "blocked") == "sorted":
                    rows[dev][k:] = rows_b[-1] if k else 0
                else:
                    pad_tile = int(b2t[dev][-1])
                    rows[dev][k:] = pad_tile * part.tile
                visited[dev][:] = 0
                visited[dev][b2t[dev]] = 1.0
                nnz_true[dev] = int(target[s])
                blocks_true[dev] = kb
            applied.append({
                "mode": mode, "group": mig.group,
                "moved_nnz": int(np.maximum(target - cur, 0).sum()),
                "nnz_after": [int(x) for x in target]})
        new_modes[mode] = dataclasses.replace(
            part, indices=inds, values=vals, local_rows=rows,
            block_to_tile=b2t, tile_visited=visited, nnz_true=nnz_true,
            blocks_true=blocks_true)
    new_plan = dataclasses.replace(plan, modes=tuple(new_modes),
                                   rebalance_epoch=plan.rebalance_epoch + 1)
    return new_plan, applied


def _rebalance_residual(step: np.ndarray, block_p: int) -> np.ndarray:
    """Zero-sum correction for a block-rounded step vector: dump the
    rounding residual (a whole number of blocks) on the largest mover."""
    res = np.zeros_like(step)
    k = int(step.sum() // block_p)
    if k != 0:
        res[int(np.argmax(np.abs(step)))] = k * block_p
    return res


# -- the sweep-facing controller --------------------------------------------

class Rebalancer:
    """Owns telemetry, the EWMA cost model, and migration decisions for one
    solve. Stateless about the plan itself — the caller (``CPSolver``)
    passes the current plan in and applies the returned decision."""

    def __init__(self, *, imbalance_threshold: float = 1.2,
                 migration_budget: float = 0.25, ewma_alpha: float = 0.5,
                 probe_repeats: int = 1, kernel_kw: dict | None = None,
                 migrate: bool = True,
                 member_nnz_caps: dict[int, int] | int | None = None):
        self.imbalance_threshold = float(imbalance_threshold)
        self.migration_budget = float(migration_budget)
        self.alpha = float(ewma_alpha)
        self.probe_repeats = int(probe_repeats)
        self.kernel_kw = kernel_kw
        self.migrate = migrate
        # per-mode (or uniform) streamed-slot budget: migrations never push
        # a member's nnz above its cap (plan_group_migrations clamp)
        self.member_nnz_caps = member_nnz_caps
        self.cost_model = cost_mod.EwmaCostModel(alpha=self.alpha)
        self.ewma_times: dict[int, np.ndarray] = {}
        # mode -> the latest probe's per-device seconds, before smoothing
        self.probe_times: dict[int, np.ndarray] = {}
        self.events: list[dict] = []

    def record(self, mode: int, times: np.ndarray) -> np.ndarray:
        prev = self.ewma_times.get(mode)
        cur = (np.asarray(times, np.float64) if prev is None
               else self.alpha * times + (1 - self.alpha) * prev)
        self.ewma_times[mode] = cur
        return cur

    def observe(self, plan, factors: Sequence[Sequence[torch.Tensor]], *,
                sweep: int, dev_arrays: Sequence) -> ReplanDecision:
        """Measure every mode's per-device EC time (``factors`` as
        :func:`measure_mode_device_times` takes them, ``dev_arrays[mode]``
        as its ``arrays``: the placed shards of ``plan``), fold it into the
        EWMA telemetry, recalibrate the cost model, and decide
        migrations."""
        imbalance, modelled = {}, {}
        feats, times_all = [], []
        for mode, part in enumerate(plan.modes):
            # looked up at call time, so a test can substitute fixed times
            t = measure_mode_device_times(
                part, factors, self.kernel_kw, arrays=dev_arrays[mode],
                repeats=self.probe_repeats)
            self.probe_times[mode] = t
            smoothed = self.record(mode, t)
            imbalance[mode] = imbalance_ratio(smoothed)
            feats.append(cost_mod.device_features(part))
            times_all.append(t)
        self.cost_model.update(np.concatenate(feats),
                               np.concatenate(times_all))
        for mode, part in enumerate(plan.modes):
            modelled[mode] = imbalance_ratio(self.cost_model.predict(part))
        migrations: list[GroupMigration] = []
        if self.migrate and self.migration_budget > 0:
            for mode, part in enumerate(plan.modes):
                if part.r > 1 and \
                        imbalance[mode] > self.imbalance_threshold:
                    caps = self.member_nnz_caps
                    cap = caps.get(mode) if isinstance(caps, dict) else caps
                    migrations.extend(plan_group_migrations(
                        part, self.ewma_times[mode],
                        migration_budget=self.migration_budget,
                        max_member_nnz=cap))
        decision = ReplanDecision(
            epoch=plan.rebalance_epoch, sweep=int(sweep),
            triggered=bool(migrations),
            imbalance=imbalance, modelled_imbalance=modelled,
            migrations=tuple(migrations))
        self.events.append({
            "sweep": int(sweep), "epoch": int(plan.rebalance_epoch),
            "imbalance": {int(k): float(v) for k, v in imbalance.items()},
            "modelled_imbalance": {int(k): float(v)
                                   for k, v in modelled.items()},
            "migrations": len(migrations),
            "moved_nnz": int(sum(m.moved_nnz for m in migrations)),
        })
        return decision
