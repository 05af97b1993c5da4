"""Host→device shard streaming with double buffering (paper §4.4/§4.8).

The counterpart of the reference package's ``sparse/stream.py``. The paper
keeps all per-mode tensor copies in host memory and moves each mode's
shards to its GPU before that mode's computation; when the tensor exceeds
device memory, the shards of the next step are prefetched while the
current one computes.

Two streamers share one residency engine (:class:`_StreamerBase`):

* :class:`ShardStreamer` — one key per MODE, whole resident shards. Owns
  the host-resident :class:`CPPlan` and yields each mode's per-device
  :class:`~repro_torch.core.mttkrp.DeviceArrays`; the dynamic rebalancer
  swaps migrated modes in the background via
  :meth:`~ShardStreamer.update_plan`.
* :class:`SuperShardStreamer` — one key per ``(mode, super_shard)`` of an
  out-of-core plan's :class:`~repro_torch.store.ModeStreamPlan` split:
  epoch streaming, where a mode's sweep iterates over budget-sized tile
  windows and super-shard k+1's transfer overlaps super-shard k's compute.
  The prefetch wraps across modes and across the sweep boundary (tensor
  data is sweep-invariant).

On a CUDA device the background thread builds a key's windows in numpy,
copies them into pinned host buffers and issues the host→device copies on
a side CUDA stream of each card, recording an event after each device's
copies (:func:`~repro_torch.core.mttkrp.place_mode`,
:func:`~repro_torch.core.mttkrp.shard_super_shard`). ``get`` makes the
compute stream wait on those events and marks the tensors used there
(``record_stream``) before it returns them, so the caching allocator never
reuses a window's memory under a running kernel.

Residency is bounded by ``prefetch + 1`` keys AT EVERY INSTANT, counting
in-flight prefetches: room is made BEFORE a load or dispatch adds a key,
LRU residents are evicted first, then superseded pending prefetches are
cancelled (or, when already executing, settled and discarded). The time
``get`` blocks on a transfer is recorded as EXPOSED transfer time, the
complement of the overlap double buffering buys
(:meth:`_StreamerBase.stats_snapshot`). Given a
:class:`~repro_torch.obs.EventLog`, a streamer also emits one
``h2d_build`` event per placement (on the thread that built it) and one
``h2d_wait`` event per blocking ``get`` — the input of
:class:`~repro_torch.obs.StreamMonitor`.

A streamer owns a background thread and must be shut down: :meth:`close`
cancels queued prefetches, joins the running one (so no background copy
outlives the streamer) and releases every shard reference. An exception
raised by a prefetch is raised again where its key is waited for, settled
or closed: none is dropped.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Hashable, Iterable

import numpy as np
import torch

# methods whose contract is "caller holds lock X" call
# ``assert_holds(lock, "X")``, a no-op unless AMPED_ANALYSIS_ASSERT_LOCKS is
# set (re-exported here for callers that import it from this module)
from repro_torch.analysis.runtime import (ENV_ASSERT, LockNotHeldError,
                                          assert_holds)
from repro_torch.core.mttkrp import (CPMesh, DeviceArrays, Placed,
                                     place_mode, shard_super_shard)
from repro_torch.core.partition import CPPlan
from repro_torch.obs import clock

__all__ = ["ShardStreamer", "SuperShardStreamer", "WindowSpill",
           "assert_holds", "LockNotHeldError", "ENV_ASSERT"]


class WindowSpill:
    """On-disk cache of materialized super-shard windows.

    Tensor data is sweep-invariant, so the packed host arrays of a
    ``(mode, device, super_shard)`` window are identical every sweep — but
    materializing one re-scans every overlapping store chunk and re-ranks
    its arrivals. The spill pays that chunk-scan once: the first build of a
    window saves its five packed arrays; later sweeps replay a sequential
    ``np.load`` + the copy to the device. Disk footprint ≈ total shard
    bytes — the out-of-core bound is HOST MEMORY, not disk.

    With ``root=None`` the spill owns a fresh temp directory and removes it
    on :meth:`close`; an explicit ``root`` persists across runs (keys carry
    the tile window and the static caps, so a plan split under a different
    budget misses cleanly and re-saves). Writes go through a same-directory
    rename, so a crashed run never leaves a partial window behind.
    """

    _NAMES = ("indices", "values", "local_rows", "block_to_tile",
              "tile_visited")

    def __init__(self, root: str | None = None):
        self._own = root is None
        self.root = root if root is not None else tempfile.mkdtemp(
            prefix="repro-torch-window-spill-")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0   # guarded-by: _lock
        self.saves = 0  # guarded-by: _lock

    def _path(self, mode: int, dev: int, key) -> str:
        # the key carries window AND static caps: the same tile window
        # split under a different budget pads to different shapes
        tag = "_".join(str(int(v)) for v in key)
        return os.path.join(self.root, f"m{mode}_d{dev}_{tag}.npz")

    def load(self, mode: int, dev: int, key):
        """The window's packed arrays, or None on a cache miss. ``key`` is
        ``(k, t0, t1, nnz_cap, nblocks)``."""
        path = self._path(mode, dev, key)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            arrs = tuple(z[n] for n in self._NAMES)
        with self._lock:
            self.hits += 1
        return arrs

    def save(self, mode: int, dev: int, key, arrs) -> None:
        path = self._path(mode, dev, key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **dict(zip(self._NAMES, arrs)))
        os.replace(tmp, path)
        with self._lock:
            self.saves += 1

    def counters(self) -> tuple[int, int]:
        """``(hits, saves)`` snapshot, consistent while builds are running
        on a streamer's prefetch thread."""
        with self._lock:
            return self.hits, self.saves

    def close(self) -> None:
        """Remove the spill directory iff this spill created it."""
        if self._own:
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _StreamerBase:
    """Keyed bounded-residency prefetch engine over a single-thread
    executor. Subclasses define :meth:`_build` (host→device placement of
    one key, a :class:`~repro_torch.core.mttkrp.Placed`) and
    :meth:`_key_nbytes` (per-device bytes a key holds)."""

    def __init__(self, mesh: CPMesh, *, prefetch: int, events=None):
        self.prefetch = prefetch
        self.mesh = mesh
        # optional repro_torch.obs.EventLog: per-window h2d_build/h2d_wait
        # events (the StreamMonitor's input); None = no structured emission
        self._events = events
        # one side copy stream per card of the mesh
        self._streams = {d.index: torch.cuda.Stream(device=d)
                         for d in mesh.devices if d.type == "cuda"}
        self._resident: OrderedDict[Hashable, Placed] = OrderedDict()
        self._pending: OrderedDict[Hashable, Future] = OrderedDict()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="shard-prefetch")
        self._closed = False
        self._stats_lock = threading.Lock()
        self._cur_bytes = 0  # guarded-by: _stats_lock
        self.stats = {  # guarded-by: _stats_lock
            "transfer_s": 0.0,       # builder wall time (host→device)
            "exposed_s": 0.0,        # time the consumer blocked on a load
            "builds": 0,
            "cold_builds": 0,        # synchronous loads (no prefetch hit)
            "bytes_streamed": 0,     # per-device bytes placed
            "peak_resident_bytes": 0,  # per-device, counting in-flight keys
        }

    # -- subclass surface --------------------------------------------------
    def _build(self, key) -> Placed:
        raise NotImplementedError

    def _key_nbytes(self, key) -> int:
        return 0

    def _key_fields(self, key) -> dict:
        """Event-log fields naming one key (mode/shard)."""
        return {"mode": key, "shard": None}

    # -- residency engine --------------------------------------------------
    def _timed_build(self, key) -> Placed:
        """One key's placement, on the prefetch thread or (cold) on the
        caller's. Its seconds end when the copies are issued and, on a card,
        have run on the side stream: the transfer time this measures is
        what a consumer would otherwise wait for."""
        t0 = clock.now()
        placed = self._build(key)
        for ev in placed.ready:
            if ev is not None:
                ev.synchronize()
        dt = clock.now() - t0
        with self._stats_lock:
            self.stats["transfer_s"] += dt
            self.stats["builds"] += 1
            self.stats["bytes_streamed"] += self._key_nbytes(key)
        if self._events is not None:
            self._events.emit("h2d_build", build_s=dt,
                              bytes=self._key_nbytes(key),
                              **self._key_fields(key))
        return placed

    def _track_add(self, key) -> None:  # holds: _stats_lock
        assert_holds(self._stats_lock, "_stats_lock")
        self._cur_bytes += self._key_nbytes(key)
        if self._cur_bytes > self.stats["peak_resident_bytes"]:
            self.stats["peak_resident_bytes"] = self._cur_bytes

    def _track_drop(self, key) -> None:  # holds: _stats_lock
        assert_holds(self._stats_lock, "_stats_lock")
        self._cur_bytes -= self._key_nbytes(key)

    def _dispatch(self, key) -> None:
        """Start moving ``key``'s shards to the devices without
        blocking."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        if key in self._resident or key in self._pending:
            return
        with self._stats_lock:
            self._track_add(key)
        self._pending[key] = self._pool.submit(self._timed_build, key)

    def _wait(self, key) -> Placed:
        """Block until ``key`` is resident (integrating a pending prefetch
        or loading synchronously on a cold miss). Block time is recorded as
        exposed transfer time — the part double buffering failed to hide."""
        fut = self._pending.pop(key, None)
        t0 = clock.now()
        cold = False
        if fut is not None:
            try:
                self._resident[key] = fut.result()
            except BaseException:
                with self._stats_lock:
                    self._track_drop(key)
                raise
        elif key not in self._resident:
            cold = True
            with self._stats_lock:
                self._track_add(key)
                self.stats["cold_builds"] += 1
            try:
                self._resident[key] = self._timed_build(key)
            except BaseException:
                with self._stats_lock:
                    self._track_drop(key)
                raise
        else:
            t0 = None
        if t0 is not None:
            waited = clock.now() - t0
            with self._stats_lock:
                self.stats["exposed_s"] += waited
            if self._events is not None:
                self._events.emit("h2d_wait", wait_s=waited, cold=cold,
                                  **self._key_fields(key))
        self._resident.move_to_end(key)
        return self._resident[key]

    def _evict(self, protect: frozenset | set = frozenset(),
               reserve: int = 0) -> None:
        """Make room: drop keys until resident + in-flight ≤
        ``prefetch + 1 - reserve`` (``reserve`` slots are about to be
        filled by the caller). LRU residents go first; then superseded
        pending prefetches are cancelled — or, when already executing,
        settled and discarded — so a fast consumer loop never holds more
        than the configured number of keys, even transiently."""
        bound = self.prefetch + 1 - reserve

        def over() -> bool:
            return len(self._resident) + len(self._pending) > bound

        while over():
            victim = next((k for k in self._resident if k not in protect),
                          None)
            if victim is None:
                break
            placed = self._resident.pop(victim)
            with self._stats_lock:
                self._track_drop(victim)
            # the tensors were marked used on the compute streams, so their
            # memory is reused only after the kernels that read them ran
            del placed
        while over():
            stale = next((k for k in self._pending if k not in protect),
                         None)
            if stale is None:
                break
            self._settle(stale)

    def _settle(self, key) -> None:
        """Cancel ``key``'s pending prefetch, waiting it out when it is
        already running. Its result is dropped; an exception it raised is
        raised here."""
        fut = self._pending.pop(key, None)
        if fut is None:
            return
        with self._stats_lock:
            self._track_drop(key)
        if not fut.cancel():
            fut.result()

    def _acquire(self, key, nxt) -> Placed:
        """Shared ``get`` body: make room, load ``key``, prefetch ``nxt``.
        Room for everything this call adds is made BEFORE anything is
        added, so the ``prefetch + 1`` bound holds at every instant."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        will_prefetch = (self.prefetch > 0 and nxt is not None
                         and nxt != key and nxt not in self._resident
                         and nxt not in self._pending)
        incoming = (0 if key in self._resident or key in self._pending
                    else 1) + (1 if will_prefetch else 0)
        protect = {key, nxt} if will_prefetch else {key}
        self._evict(protect=protect, reserve=incoming)
        cur = self._wait(key)
        if will_prefetch:
            self._dispatch(nxt)
        return cur

    def resident_keys(self) -> list:
        """Keys currently holding (or acquiring) device memory, LRU
        first."""
        return list(self._resident) + list(self._pending)

    def stats_snapshot(self) -> dict:
        """Copy of the transfer counters — monotonic totals; callers diff
        snapshots for per-sweep numbers. ``hidden_s`` is the transfer time
        the prefetch overlapped behind compute."""
        with self._stats_lock:
            s = dict(self.stats)
            s["resident_bytes"] = self._cur_bytes
        s["hidden_s"] = max(s["transfer_s"] - s["exposed_s"], 0.0)
        return s

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Shut down the prefetch thread: cancel queued prefetches, join
        the running one, drop every shard reference. Idempotent. After
        close, :meth:`get` raises ``RuntimeError``. The first exception a
        settled prefetch raised is raised once everything is released."""
        if self._closed:
            return
        self._closed = True
        failure = None
        for key in list(self._pending):
            try:
                self._settle(key)
            except Exception as e:  # noqa: BLE001 — raised below
                failure = failure or e
        self._pool.shutdown(wait=True)
        for key in list(self._resident):
            self._resident.pop(key)
            with self._stats_lock:
                self._track_drop(key)
        if failure is not None:
            raise failure

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardStreamer(_StreamerBase):
    """Whole-shard-per-mode streamer (keys are mode ids)."""

    def __init__(self, plan: CPPlan, mesh: CPMesh, *, prefetch: int = 1,
                 events=None):
        super().__init__(mesh, prefetch=prefetch, events=events)
        self.plan = plan

    def _build(self, mode: int) -> Placed:
        return place_mode(self.plan.modes[mode], self.mesh,
                          streams=self._streams)

    def resident_modes(self) -> list[int]:
        """Modes currently holding (or acquiring) device memory, LRU
        first."""
        return self.resident_keys()

    def get(self, mode: int) -> list[DeviceArrays]:
        """Shards for ``mode``, ready on each device's current stream;
        dispatches a prefetch of ``(mode+1) % nmodes`` before returning."""
        return self._acquire(mode, (mode + 1) % self.plan.nmodes).wait()

    def update_plan(self, plan: CPPlan,
                    modes: Iterable[int] | None = None) -> None:
        """Swap in a rebalanced plan: drop the listed modes' stale shards
        (all modes when None) and prefetch their replacements in the
        background. Pending prefetches of stale modes are cancelled — or,
        when already executing against the outgoing plan, settled and
        discarded — before the plan pointer moves, so no background build
        mixes the two plans. Array shapes are unchanged by construction
        (schedule.rebalance migrates within padding headroom)."""
        stale = set(range(self.plan.nmodes) if modes is None else modes)
        for mode in stale:
            self._settle(mode)
            if mode in self._resident:
                self._resident.pop(mode)
                with self._stats_lock:
                    self._track_drop(mode)
        self.plan = plan
        for mode in sorted(stale):
            if len(self._resident) + len(self._pending) >= self.prefetch + 1:
                break  # respect the residency bound; the rest load on demand
            self._dispatch(mode)
        self._evict()


class SuperShardStreamer(_StreamerBase):
    """Epoch streaming: keys are ``(mode, super_shard)`` pairs of an
    out-of-core plan split by :func:`repro_torch.store.split_mode_super_shards`.

    ``buffers`` concurrently resident super-shards (2 = double buffering:
    shard k+1's transfer runs behind shard k's compute; the residency bound
    is exactly ``buffers`` keys, so peak streamed device bytes stay ≤ the
    budget the stream plans were split for). The prefetch chain follows
    sweep order: (d, k) → (d, k+1), wrapping to (d+1, 0) — and across the
    sweep boundary to (0, 0)."""

    def __init__(self, plan: CPPlan, mesh: CPMesh, stream_plans, *,
                 buffers: int = 2, spill: WindowSpill | None = None,
                 events=None):
        if buffers < 1:
            raise ValueError("buffers must be >= 1")
        super().__init__(mesh, prefetch=buffers - 1, events=events)
        self.plan = plan
        self.stream_plans = list(stream_plans)
        self.spill = spill

    def _build(self, key) -> Placed:
        mode, k = key
        return shard_super_shard(self.plan.modes[mode],
                                 self.stream_plans[mode], k, self.mesh,
                                 spill=self.spill, streams=self._streams)

    def stats_snapshot(self) -> dict:
        s = super().stats_snapshot()
        if self.spill is not None:
            hits, saves = self.spill.counters()
            s["spill_hits"] = hits
            s["spill_saves"] = saves
        return s

    def close(self) -> None:
        try:
            super().close()
        finally:
            if self.spill is not None:
                self.spill.close()

    def _key_nbytes(self, key) -> int:
        return self.stream_plans[key[0]].shard_bytes

    def _key_fields(self, key) -> dict:
        return {"mode": key[0], "shard": key[1]}

    def _next_key(self, key):
        mode, k = key
        if k + 1 < self.stream_plans[mode].num_shards:
            return (mode, k + 1)
        return ((mode + 1) % self.plan.nmodes, 0)

    def get(self, mode: int, k: int) -> list[DeviceArrays]:
        """Super-shard ``k`` of ``mode``, ready on each device's current
        stream; dispatches a prefetch of the next super-shard in sweep
        order before returning."""
        key = (mode, k)
        return self._acquire(key, self._next_key(key)).wait()
