"""The port's streamers (``repro_torch.sparse.stream``) on the CPU: the
contract of the reference's tests/test_stream.py — bounded residency
counting in-flight prefetches, LRU eviction, wrap-around and asynchronous
prefetch, cancellation of superseded prefetches, ``close()`` joining the
running build, plan swaps after a migration — plus the window spill's round
trip, and a failing prefetch raising where its key is used (the port
swallows no exception of its thread)."""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cases import skewed_tensor  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.core import mttkrp as dm  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.core.partition import build_plan  # noqa: E402
from repro_torch.sparse import stream as st  # noqa: E402
from repro_torch.store import (TensorStore, build_plan_from_store,  # noqa: E402
                               split_mode_super_shards, write_store_from_coo)

TIMEOUT = 10


@pytest.fixture(scope="module")
def tensor4():
    return random_sparse((20, 15, 12, 10), 400, seed=8)


@pytest.fixture(scope="module")
def plan4(tensor4):
    return build_plan(tensor4, 1)


@pytest.fixture()
def mesh():
    return dm.cp_mesh(1, 1, devices=["cpu"])


def _streamer(plan, mesh, prefetch=1, loads=None):
    s = st.ShardStreamer(plan, mesh, prefetch=prefetch)
    if loads is not None:
        orig = s._build

        def counting_build(mode):
            loads.append(mode)
            return orig(mode)

        s._build = counting_build
    return s


def _gate(s, modes, release, started=None):
    orig = s._build

    def gated(mode, _orig=orig):
        if mode in modes:
            if started is not None:
                started.set()
            assert release.wait(timeout=TIMEOUT)
        return _orig(mode)

    s._build = gated


def test_placed_shards_are_walked_not_copied(plan4, mesh, monkeypatch):
    """``DeviceArrays.tensors()`` (what ``nbytes`` and ``Placed.wait``
    walk) hands out the placed tensors themselves. ``dataclasses.astuple``
    deep-copied each one: a device copy of every shard per sweep, and
    ``record_stream`` marked the copies instead of the shards."""
    import copy
    dev = dm.shard_plan_mode(plan4.modes[0], mesh)[0]
    fields = (dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
              dev.seg_starts, dev.seg_rows, dev.items)
    assert all(a is b for a, b in zip(dev.tensors(), fields, strict=True))

    def no_copy(*a, **k):
        raise AssertionError("a placed tensor was deep-copied")

    monkeypatch.setattr(copy, "deepcopy", no_copy)
    assert dev.nbytes() == sum(t.numel() * t.element_size() for t in fields)
    placed = dm.Placed([dev], [None])
    assert placed.wait()[0] is dev


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_residency_never_exceeds_prefetch_plus_one(plan4, mesh, prefetch):
    with _streamer(plan4, mesh, prefetch=prefetch) as s:
        for step in range(12):
            arrays = s.get(step % plan4.nmodes)
            assert len(arrays) == 1 and arrays[0].values.device.type == "cpu"
            assert len(s.resident_modes()) <= prefetch + 1


def test_pending_prefetch_counts_against_bound(plan4, mesh):
    peaks = []
    s = _streamer(plan4, mesh, prefetch=1)
    orig_add = s._track_add

    def checking_add(key, _orig=orig_add):
        peaks.append(len(s._resident) + len(s._pending) + 1)
        _orig(key)

    s._track_add = checking_add
    for step in range(12):
        s.get(step % plan4.nmodes)
        assert len(s._resident) + len(s._pending) <= 2
    assert peaks and max(peaks) <= 2
    s.close()


def test_eviction_is_lru_and_prefetch_wraps(plan4, mesh):
    with _streamer(plan4, mesh, prefetch=1) as s:
        s.get(0)
        s.get(1)
        s.get(2)
        alive = s.resident_modes()
        assert 0 not in alive and 2 in alive
        s.get(3)
        s.get(3)
        assert 3 in s.resident_modes()
        assert 0 in s.resident_modes()   # mode nmodes-1 prefetches mode 0
    loads = []
    with _streamer(plan4, mesh, prefetch=1, loads=loads) as s:
        s.get(3)
        s.get(0)
        assert loads[:2] == [3, 0] and loads.count(0) == 1


def test_prefetch_is_async_and_zero_prefetch_is_on_demand(plan4, mesh):
    started, release = threading.Event(), threading.Event()
    s = _streamer(plan4, mesh, prefetch=1)
    _gate(s, {1}, release, started)
    s.get(0)                 # returns while mode 1 is still loading
    assert started.wait(timeout=TIMEOUT)
    assert 1 not in s._resident and 1 in s.resident_modes()
    release.set()
    s.get(1)
    assert 1 in s._resident
    s.close()
    loads = []
    with _streamer(plan4, mesh, prefetch=0, loads=loads) as s:
        s.get(0)
        s.get(1)
    assert loads == [0, 1]


def test_superseded_prefetch_cancelled_or_settled(plan4, mesh):
    release = threading.Event()
    loads = []
    s = _streamer(plan4, mesh, prefetch=2, loads=loads)
    _gate(s, {1}, release)
    s.get(0)           # pending {1}, blocked in the worker
    s._dispatch(2)     # queued behind mode 1: cancellable
    s._settle(2)
    release.set()
    s._wait(1)
    s.close()
    assert 2 not in loads
    release2 = threading.Event()
    s = _streamer(plan4, mesh, prefetch=1)
    _gate(s, {1}, release2)
    s.get(0)
    timer = threading.Timer(0.2, release2.set)
    timer.start()
    s.get(2)           # diverges: the mode-1 prefetch is settled
    timer.join()
    assert set(s._resident) | set(s._pending) <= {2, 3}
    s.close()


def test_close_joins_inflight_build_and_is_final(plan4, mesh):
    started, release = threading.Event(), threading.Event()
    s = _streamer(plan4, mesh, prefetch=2)
    _gate(s, {1}, release, started)
    s.get(0)
    s._dispatch(2)
    assert started.wait(timeout=TIMEOUT)
    closer = threading.Thread(target=s.close)
    closer.start()
    assert closer.is_alive()      # close waits for the running build
    release.set()
    closer.join(timeout=TIMEOUT)
    assert not closer.is_alive()
    assert not s._pending and not s._resident and s._pool._shutdown
    with pytest.raises(RuntimeError, match="closed"):
        s.get(0)
    s.close()                     # idempotent


def test_a_failing_prefetch_raises_where_it_is_used(plan4, mesh):
    s = _streamer(plan4, mesh, prefetch=1)
    orig = s._build

    def broken(mode, _orig=orig):
        if mode == 1:
            raise OSError("chunk read failed")
        return _orig(mode)

    s._build = broken
    s.get(0)                      # dispatches the failing mode-1 build
    with pytest.raises(OSError, match="chunk read failed"):
        s.get(1)
    assert s.stats_snapshot()["resident_bytes"] == 0
    s.close()
    s = _streamer(plan4, mesh, prefetch=1)
    s._build = broken
    s.get(0)
    with pytest.raises(OSError, match="chunk read failed"):
        s.close()                 # settled at close: raised, not dropped
    assert s._closed and s._pool._shutdown and not s._resident


def test_update_plan_swaps_migrated_modes(plan4, mesh, tensor4):
    with _streamer(plan4, mesh, prefetch=plan4.nmodes) as s:
        before = [s.get(d) for d in range(plan4.nmodes)]
        plan_b = build_plan(tensor4, 1)  # fresh arrays, same shapes
        seen = []
        orig = s._build
        s._build = lambda mode, _o=orig: (seen.append(s.plan), _o(mode))[1]
        s.update_plan(plan_b, modes=[1])
        after = [s.get(d) for d in range(plan4.nmodes)]
        assert after[0] is before[0] and after[1] is not before[1]
        assert seen == [plan_b]
        np.testing.assert_array_equal(after[1][0].values.numpy(),
                                      plan_b.modes[1].values[0])


def test_window_spill_round_trip(tmp_path):
    arrs = (np.arange(12, dtype=np.int32).reshape(4, 3),
            np.linspace(0, 1, 4).astype(np.float32),
            np.array([0, 0, 1, 3], np.int32), np.array([0], np.int32),
            np.array([1.0, 0.0], np.float32))
    with st.WindowSpill() as spill:
        root = spill.root
        assert spill.load(0, 1, (0, 0, 2, 4, 1)) is None
        spill.save(0, 1, (0, 0, 2, 4, 1), arrs)
        back = spill.load(0, 1, (0, 0, 2, 4, 1))
        for a, b in zip(arrs, back, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert spill.counters() == (1, 1)
        assert spill.load(0, 1, (0, 0, 2, 8, 2)) is None  # other caps
        assert not [f for f in os.listdir(root) if f.endswith(".tmp")]
    assert not os.path.exists(root)       # an owned spill is removed
    keep = str(tmp_path / "spill")
    with st.WindowSpill(keep) as spill:
        spill.save(2, 0, (1, 3, 5, 4, 1), arrs)
    assert os.listdir(keep) == ["m2_d0_1_3_5_4_1.npz"]


def test_super_shard_streamer_bound_and_spill(tmp_path):
    t = skewed_tensor()
    path = str(tmp_path / "s.store")
    write_store_from_coo(t, path, chunk_nnz=512)
    plan = build_plan_from_store(TensorStore(path), 2, strategy="equal_nnz")
    budget = 2 * max(p.nnz_max for p in plan.modes) * 20 // 2
    sps = [split_mode_super_shards(p, budget) for p in plan.modes]
    assert max(sp.num_shards for sp in sps) >= 2
    mesh = dm.cp_mesh(2, 2, devices=["cpu"] * 2)
    spill = st.WindowSpill()
    s = st.SuperShardStreamer(plan, mesh, sps, buffers=2, spill=spill)
    keys = [(d, k) for d in range(3) for k in range(sps[d].num_shards)]
    first = {}
    for sweep in range(2):
        for key in keys:
            got = s.get(*key)
            assert len(s.resident_keys()) <= 2
            if sweep == 0:
                first[key] = [x.values.clone() for x in got]
            else:  # replayed from the spill, bitwise
                for a, b in zip(first[key], got):
                    assert torch.equal(a, b.values)
    snap = s.stats_snapshot()
    assert snap["peak_resident_bytes"] <= budget
    assert snap["spill_saves"] > 0 and snap["spill_hits"] > 0
    assert snap["hidden_s"] >= 0 and snap["builds"] >= len(keys)
    root = spill.root
    s.close()
    assert not os.path.exists(root)


def test_solver_close_and_context_manager(tensor4):
    cfg = tapi.paper({"rank": 4, "runtime.tol": 0.0})
    plan = tapi.plan(tensor4, cfg, device="cpu")
    with tapi.compile(plan, cfg, device="cpu") as solver:
        solver.sweep()
        streamer = solver.streamer
    assert streamer._closed
    with pytest.raises(RuntimeError, match="closed"):
        solver.sweep()
    solver.close()


def test_lock_assertion(monkeypatch):
    lock = threading.Lock()
    st.assert_holds(lock, "x")            # off by default
    monkeypatch.setenv(st.ENV_ASSERT, "1")
    with pytest.raises(st.LockNotHeldError, match="x held"):
        st.assert_holds(lock, "x")
    with lock:
        st.assert_holds(lock, "x")


def test_counters_hold_under_thread_switching(tmp_path):
    """The prefetch thread and the consumer share the byte and build
    counters: with the interpreter switching threads every microsecond,
    resident bytes never pass the budget, every build is counted once,
    and close() leaves nothing resident."""
    import sys
    t = skewed_tensor(nnz=3000, seed=4)
    path = str(tmp_path / "s.store")
    write_store_from_coo(t, path, chunk_nnz=256)
    plan = build_plan_from_store(TensorStore(path), 2, strategy="equal_nnz")
    budget = max(p.nnz_max for p in plan.modes) * 20
    sps = [split_mode_super_shards(p, budget) for p in plan.modes]
    mesh = dm.cp_mesh(2, 2, devices=["cpu"] * 2)
    s = st.SuperShardStreamer(plan, mesh, sps, buffers=2)
    builds = []
    orig = s._build
    s._build = lambda key, _o=orig: (builds.append(key), _o(key))[1]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            for d in range(3):
                for k in range(sps[d].num_shards):
                    s.get(d, k)
                    snap = s.stats_snapshot()
                    assert snap["resident_bytes"] <= budget
                    assert len(s.resident_keys()) <= 2
    finally:
        sys.setswitchinterval(old)
        s.close()
    snap = s.stats_snapshot()
    assert snap["resident_bytes"] == 0 and not s.resident_keys()
    assert snap["builds"] == len(builds)
    assert snap["peak_resident_bytes"] <= budget
