"""The port's serving subsystem (repro_torch.serve) on the CPU.

Twins of tests/test_serve.py's 28 tests, on ``device="cpu"`` and with the
reference's tolerances: engine values within rtol 1e-4 / atol 1e-5 of the
float64 ``reconstruct_at``, top-k against numpy's dense scores, admission
control, bitwise-stable answers during a background refit, rollback on a
fit regression, and the incremental refresh within 1e-3 of a
from-scratch refit. Plus cross-package cases:

* a checkpoint written by the reference boots the port's ``CPService``,
  whose ``reconstruct`` is within 1e-5 relative of the reference engine's
  at the same coordinates (both fp32, summed in a different order);
* the port's ``incremental_refit`` and the reference's on one grown store
  with one seed give sweep fits and a published fit within 1e-4 (the
  cross-package ALS tolerance of tests/test_torch_als.py: the packages'
  eigh and matmul round differently);
* ``metrics_report()`` has the same key tree in both packages;
* ``python -m repro_torch.serve --once --device cpu`` prints a
  ``metrics_report`` line with the reference CLI's keys.
"""
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro_torch.api as api  # noqa: E402
from repro_torch.api.config import DecomposeConfig, RuntimeConfig  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.core.decompose import validate_coords  # noqa: E402
from repro_torch.serve import (CPService, FactorSnapshot,  # noqa: E402
                               MicroBatcher, RejectedError, ServiceMetrics,
                               ServingEngine, store_fit)
from repro_torch.serve.metrics import LatencyHistogram  # noqa: E402
from repro_torch.sparse.io import make_lowrank_tensor  # noqa: E402
from repro_torch.store import (TensorStore, append_to_store,  # noqa: E402
                               write_store_from_coo)
from repro_torch.store.format import StoreFormatError  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402

RANK = 4
SHAPE = (48, 40, 32)
CHUNK = 512
CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(ckpt_dir=None, seed=0):
    return DecomposeConfig(rank=RANK, runtime=RuntimeConfig(
        num_devices=1, tol=0.0, seed=seed, checkpoint_dir=ckpt_dir))


def _solver(store, cfg):
    return api.compile(api.plan(store, cfg, device=CPU), cfg, device=CPU)


@pytest.fixture(scope="module")
def lowrank():
    """An exactly rank-RANK sparse tensor plus its base/append split."""
    t = make_lowrank_tensor(SHAPE, RANK, 3000, seed=0)
    base_n = int(t.nnz * 0.85)
    return t, base_n


@pytest.fixture(scope="module")
def fitted(lowrank, tmp_path_factory):
    """Base store + 10-sweep fit + checkpoint directory (shared,
    read-only — tests that append copy the store first)."""
    t, base_n = lowrank
    root = tmp_path_factory.mktemp("serve_fit")
    store_path = str(root / "base.store")
    base = SparseTensor(t.indices[:base_n], t.values[:base_n], t.shape)
    write_store_from_coo(base, store_path, chunk_nnz=CHUNK)
    ckpt = str(root / "ckpts")
    cfg = _config(ckpt_dir=ckpt)
    with _solver(TensorStore(store_path), cfg) as solver:
        result = solver.run(10)
    return {"store_path": store_path, "ckpt": ckpt, "result": result}


def _copy_store(fitted, tmp_path):
    dst = str(tmp_path / "grow.store")
    shutil.copytree(fitted["store_path"], dst)
    return dst


def _boot(ckpt, **kw):
    return CPService.boot(ckpt, device=CPU, **kw)


# -- engine ---------------------------------------------------------------

def test_reconstruct_parity_across_buckets(fitted):
    res = fitted["result"]
    engine = ServingEngine(FactorSnapshot.from_result(res, device=CPU))
    rng = np.random.default_rng(1)
    sizes = [1, 2, 3, 7, 8, 9, 17, 33, 100, 257]
    for n in sizes:
        coords = np.stack([rng.integers(0, s, size=n) for s in SHAPE],
                          axis=1)
        got = engine.reconstruct_batch(coords)
        want = res.reconstruct_at(coords)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    buckets = {max(8, 1 << (int(n) - 1).bit_length()) for n in sizes}
    assert engine.metrics.gauge("reconstruct_buckets") <= len(buckets)


def test_reconstruct_batch_chunks_beyond_max_batch(fitted):
    res = fitted["result"]
    engine = ServingEngine(FactorSnapshot.from_result(res, device=CPU),
                           max_batch=64)
    rng = np.random.default_rng(2)
    coords = np.stack([rng.integers(0, s, size=300) for s in SHAPE], axis=1)
    np.testing.assert_allclose(engine.reconstruct_batch(coords),
                               res.reconstruct_at(coords),
                               rtol=1e-4, atol=1e-5)


def test_topk_matches_dense_argsort():
    rng = np.random.default_rng(3)
    shape, rank, k = (12, 37, 9), 5, 6
    factors = [rng.standard_normal((s, rank)).astype(np.float32)
               for s in shape]
    lam = rng.uniform(0.5, 2.0, rank).astype(np.float32)
    engine = ServingEngine(
        FactorSnapshot.from_arrays(factors, lam, version=1, device=CPU))
    fixed = np.array([4, 0, 7])
    scores, idx = engine.topk_slice(fixed, mode=1, k=k)
    dense = np.zeros(shape[1])
    for j in range(shape[1]):
        acc = lam.astype(np.float64).copy()
        acc *= factors[0][4].astype(np.float64)
        acc *= factors[1][j].astype(np.float64)
        acc *= factors[2][7].astype(np.float64)
        dense[j] = acc.sum()
    order = np.argsort(-dense)[:k]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_allclose(scores, dense[order], rtol=1e-4, atol=1e-5)
    batch = np.array([[4, 999, 7], [0, 0, 0], [11, 3, 8]])
    bs, bi = engine.topk_slice(batch, mode=1, k=k)
    np.testing.assert_array_equal(bi[0], order)
    np.testing.assert_allclose(bs[0], scores, rtol=1e-6)


def test_topk_validation():
    rng = np.random.default_rng(4)
    factors = [rng.standard_normal((8, 3)).astype(np.float32)
               for _ in range(3)]
    engine = ServingEngine(FactorSnapshot.from_arrays(
        factors, np.ones(3, np.float32), version=1, device=CPU))
    with pytest.raises(ValueError, match="mode 5"):
        engine.topk_slice(np.zeros(3, np.int64), mode=5, k=2)
    with pytest.raises(ValueError, match="k="):
        engine.topk_slice(np.zeros(3, np.int64), mode=1, k=99)
    with pytest.raises(IndexError, match="mode 0"):
        engine.topk_slice(np.array([88, 0, 0]), mode=1, k=2)


def test_publish_swap_and_validation(fitted):
    res = fitted["result"]
    engine = ServingEngine(FactorSnapshot.from_result(res, device=CPU))
    v2 = FactorSnapshot.from_arrays(res.factors, res.lam, version=2,
                                    device=CPU)
    engine.publish(v2)
    assert engine.version == 2
    with pytest.raises(ValueError, match="version"):
        engine.publish(FactorSnapshot.from_arrays(res.factors, res.lam,
                                                  version=2, device=CPU))
    bad_rank = [np.zeros((s, RANK + 1), np.float32) for s in SHAPE]
    with pytest.raises(ValueError, match="rank"):
        engine.publish(FactorSnapshot.from_arrays(
            bad_rank, np.ones(RANK + 1, np.float32), version=3, device=CPU))


# -- bounds/rank validation satellites ------------------------------------

def test_reconstruct_at_rejects_out_of_range(fitted):
    res = fitted["result"]
    with pytest.raises(IndexError, match=r"mode 1.*row 1"):
        res.reconstruct_at(np.array([[0, 0, 0], [0, -1, 0]]))
    with pytest.raises(IndexError, match="mode 2"):
        res.reconstruct_at(np.array([[0, 0, SHAPE[2]]]))
    with pytest.raises(ValueError, match=r"\(k, 3\)"):
        res.reconstruct_at(np.zeros((4, 2), np.int64))


def test_validate_coords_passthrough():
    ind = validate_coords(np.array([[0, 1], [3, 2]], np.int32), (4, 3))
    assert ind.dtype == np.int64


def test_engine_rejects_out_of_range(fitted):
    engine = ServingEngine(FactorSnapshot.from_result(fitted["result"],
                                                      device=CPU))
    with pytest.raises(IndexError, match="mode 0"):
        engine.reconstruct_batch(np.array([[SHAPE[0], 0, 0]]))


def test_restore_rank_mismatch_names_both_ranks(fitted):
    store = TensorStore(fitted["store_path"])
    cfg8 = DecomposeConfig(rank=8, runtime=RuntimeConfig(
        num_devices=1, tol=0.0, seed=0, checkpoint_dir=fitted["ckpt"]))
    with _solver(store, cfg8) as solver:
        with pytest.raises(ValueError, match=r"rank 4.*rank 8"):
            solver.restore()


def test_boot_rank_mismatch_names_both_ranks(fitted):
    with pytest.raises(ValueError, match=r"rank 4.*rank 9"):
        _boot(fitted["ckpt"], rank=9)


def test_load_state_validates_mode_shape(fitted):
    store = TensorStore(fitted["store_path"])
    with _solver(store, _config()) as solver:
        bad = [np.ones((s + 1, RANK), np.float32) for s in SHAPE]
        with pytest.raises(ValueError, match="mode 0"):
            solver.load_state(bad, np.ones(RANK, np.float32))


# -- store append / refresh ----------------------------------------------

def test_append_to_store_matches_full_rewrite(lowrank, fitted, tmp_path):
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    append_to_store(grown, t.indices[base_n:].astype(np.int64),
                    t.values[base_n:])
    ref = str(tmp_path / "ref.store")
    write_store_from_coo(t, ref, chunk_nnz=CHUNK)
    sa, sb = TensorStore(grown), TensorStore(ref)
    assert sa.nnz == sb.nnz == t.nnz
    assert [c["min"] for c in sa.manifest["chunks"]] == \
        [c["min"] for c in sb.manifest["chunks"]]
    assert [c["hist"] for c in sa.manifest["chunks"]] == \
        [c["hist"] for c in sb.manifest["chunks"]]
    assert abs(sa.manifest["values_sumsq"] -
               sb.manifest["values_sumsq"]) < 1e-6
    for d in range(3):
        np.testing.assert_array_equal(sa.mode_histogram(d),
                                      sb.mode_histogram(d))
    for (ia, va), (ib, vb) in zip(sa.iter_chunks(), sb.iter_chunks()):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(va, vb)


def test_append_validates(fitted, tmp_path):
    grown = _copy_store(fitted, tmp_path)
    with pytest.raises(ValueError, match="out of range"):
        append_to_store(grown, np.array([[SHAPE[0], 0, 0]]),
                        np.ones(1, np.float32))
    with pytest.raises(ValueError, match="negative"):
        append_to_store(grown, np.array([[-1, 0, 0]]),
                        np.ones(1, np.float32))


def test_store_refresh_delta_and_noop(lowrank, fitted, tmp_path):
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    store = TensorStore(grown)
    assert store.refresh() is None
    old_nnz, old_chunks = store.nnz, store.num_chunks
    append_to_store(grown, t.indices[base_n:].astype(np.int64),
                    t.values[base_n:])
    delta = store.refresh()
    assert delta["old_nnz"] == old_nnz and delta["new_nnz"] == t.nnz
    assert delta["appended_nnz"] == t.nnz - base_n
    assert delta["first_changed_chunk"] == old_nnz // CHUNK
    assert store.nnz == t.nnz and store.num_chunks >= old_chunks
    rows = store.appended_mode_rows(delta["old_nnz"])
    for d in range(3):
        np.testing.assert_array_equal(
            rows[d], np.unique(t.indices[base_n:, d]))


def test_store_refresh_rejects_rewrite(lowrank, fitted, tmp_path):
    t, _ = lowrank
    grown = _copy_store(fitted, tmp_path)
    store = TensorStore(grown)
    shutil.rmtree(grown)
    small = SparseTensor(t.indices[:100], t.values[:100], t.shape)
    write_store_from_coo(small, grown, chunk_nnz=CHUNK)
    with pytest.raises(StoreFormatError, match="shrank"):
        store.refresh()


# -- metrics / batcher ----------------------------------------------------

def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    for ms in range(1, 101):
        h.record(ms * 1e-3)
    assert h.count == 100
    p50, p99 = h.percentile(0.50), h.percentile(0.99)
    assert 0.04 <= p50 <= 0.07
    assert 0.08 <= p99 <= 0.14
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["p50_ms"] >= 1.0


def test_metrics_report_shape():
    m = ServiceMetrics()
    m.inc("queries_total", 5)
    m.set_gauge("queue_depth", 2)
    with m.time("reconstruct"):
        pass
    rep = m.metrics_report()
    assert rep["counters"]["queries_total"] == 5
    assert rep["gauges"]["queue_depth"] == 2
    assert rep["latency"]["reconstruct"]["count"] == 1
    assert rep["qps"] > 0


def test_batcher_coalesces_and_scatters():
    calls = []

    def handler(ind):
        calls.append(ind.shape[0])
        return ind[:, 0].astype(np.float32) * 2

    with MicroBatcher(handler, max_delay_s=0.2, max_depth=16) as mb:
        results = {}

        def client(i):
            results[i] = mb.submit(np.array([[i, 0], [i + 1, 0]]))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    for i in range(4):
        np.testing.assert_array_equal(results[i], [2 * i, 2 * (i + 1)])
    assert sum(calls) == 8
    assert len(calls) < 4


def test_batcher_stress_each_request_gets_its_rows():
    """More client threads than cores, a short switch interval: every
    request gets back exactly its own rows, whatever the coalescing."""
    def handler(ind):
        return ind[:, 0].astype(np.float32) + 0.5

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with MicroBatcher(handler, max_delay_s=0.001, max_batch=64,
                          max_depth=1024, default_deadline_s=30.0) as mb:
            bad = []

            def client(c):
                for i in range(50):
                    rows = np.array([[c * 1000 + i * 10 + j, 0]
                                     for j in range(1 + (c + i) % 5)])
                    got = mb.submit(rows)
                    if not np.array_equal(got, rows[:, 0] + 0.5):
                        bad.append((c, i))

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(4 * (os.cpu_count() or 1))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
            assert not bad
            assert mb.metrics.counter("batched_requests_total") == \
                50 * len(threads)
    finally:
        sys.setswitchinterval(old)


def test_batcher_rejects_when_queue_full():
    gate = threading.Event()
    entered = threading.Event()

    def handler(ind):
        entered.set()
        gate.wait(5)
        return np.zeros(ind.shape[0], np.float32)

    mb = MicroBatcher(handler, max_delay_s=0.0, max_depth=2,
                      default_deadline_s=10.0)
    fillers = []
    req = np.zeros((1, 2), np.int64)
    t0 = threading.Thread(target=lambda: mb.submit(req))
    try:
        t0.start()
        assert entered.wait(5)
        fillers = [threading.Thread(target=lambda: mb.submit(req))
                   for _ in range(2)]
        for th in fillers:
            th.start()
        deadline = 50
        while mb.metrics.gauge("queue_depth", 0) < 2 and deadline:
            threading.Event().wait(0.02)
            deadline -= 1
        assert mb.metrics.gauge("queue_depth", 0) == 2
        with pytest.raises(RejectedError, match="max depth"):
            mb.submit(req)
        assert mb.metrics.counter("rejected_total") == 1
    finally:
        gate.set()
        for th in [t0] + fillers:
            th.join(5)
        mb.close()


def test_batcher_deadline_rejection():
    def handler(ind):
        threading.Event().wait(0.2)
        return np.zeros(ind.shape[0], np.float32)

    with MicroBatcher(handler, max_delay_s=0.0) as mb:
        with pytest.raises(RejectedError, match="deadline"):
            mb.submit(np.zeros((1, 2), np.int64), deadline_s=0.05)


def test_batcher_propagates_handler_errors(fitted):
    engine = ServingEngine(FactorSnapshot.from_result(fitted["result"],
                                                      device=CPU))
    with MicroBatcher(engine.reconstruct_batch) as mb:
        with pytest.raises(IndexError, match="mode 0"):
            mb.submit(np.array([[-1, 0, 0]]))


# -- service lifecycle ----------------------------------------------------

def test_boot_serves_checkpoint(fitted):
    res = fitted["result"]
    with _boot(fitted["ckpt"]) as svc:
        assert svc.engine.version == 1
        assert svc.engine.snapshot.rank == RANK
        assert svc.engine.snapshot.device.type == "cpu"
        coords = np.array([[1, 2, 3], [0, 0, 0]])
        np.testing.assert_allclose(svc.reconstruct(coords),
                                   res.reconstruct_at(coords),
                                   rtol=1e-4, atol=1e-5)
        rep = svc.metrics_report()
        assert rep["snapshot"]["version"] == 1
        assert rep["counters"]["queries_total"] >= 1


def test_boot_no_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="no verified checkpoint"):
        _boot(str(tmp_path / "empty"))


def test_incremental_refresh_matches_scratch_refit(lowrank, fitted,
                                                   tmp_path):
    """After an append, the frozen-row warm-start refit publishes a
    snapshot whose exact store fit is within 1e-3 of a from-scratch refit
    of the grown store."""
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    store = TensorStore(grown)
    with _boot(fitted["ckpt"], store=store, config=_config()) as svc:
        append_to_store(grown, t.indices[base_n:].astype(np.int64),
                        t.values[base_n:])
        event = svc.refresh(sweeps=6)
        assert event["published"], event
        assert svc.engine.version == 2
        warm_fit = event["refit"]["fit"]
        assert event["refit"]["frozen"]
        assert any(f < 1.0 for f in event["refit"]["affected_fraction"])
        assert set(event["refit"]["seconds"]) == {
            "plan", "compile", "sweeps", "freeze_blend", "store_fit"}
        assert event["sample_fit_s"] >= 0.0
    store2 = TensorStore(grown)
    with _solver(store2, _config(seed=0)) as solver:
        scratch = solver.run(12)
    scratch_fit = store_fit(scratch.factors, scratch.lam, store2)
    assert abs(warm_fit - scratch_fit) < 1e-3, (warm_fit, scratch_fit)
    assert warm_fit > 0.99


def test_refresh_noop_without_growth(fitted, tmp_path):
    grown = _copy_store(fitted, tmp_path)
    with _boot(fitted["ckpt"], store=TensorStore(grown),
               config=_config()) as svc:
        event = svc.refresh()
        assert event == {"refreshed": False, "reason": "store unchanged"}
        assert svc.engine.version == 1


def test_concurrent_queries_during_background_refit(lowrank, fitted,
                                                    tmp_path):
    """Queries keep flowing during a background refit and every answer is
    bitwise one of the two published snapshots' answers."""
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    store = TensorStore(grown)
    rng = np.random.default_rng(5)
    coords = np.stack([rng.integers(0, s, size=64) for s in SHAPE], axis=1)
    with _boot(fitted["ckpt"], store=store, config=_config()) as svc:
        snap_v1 = svc.engine.snapshot
        want_v1 = svc.reconstruct(coords)
        append_to_store(grown, t.indices[base_n:].astype(np.int64),
                        t.values[base_n:])
        event = svc.refresh(sweeps=4, wait=False)
        assert event["background"]
        assert svc.metrics.gauge("refit_in_progress", 0) == 1
        answers = []
        while True:  # the last query starts after the publish
            running = svc.metrics.gauge("refit_in_progress", 0) == 1
            answers.append(svc.reconstruct(coords))
            if not running:
                break
        done = svc.wait_refresh()
        assert done["published"] and svc.engine.version == 2
        assert svc.engine.snapshot is not snap_v1
        want_v2 = svc.reconstruct(coords)
    for a in answers:
        assert np.array_equal(a, want_v1) or np.array_equal(a, want_v2)
    assert not np.array_equal(want_v1, want_v2)
    # the first query began while the refit ran, the last after the publish
    assert np.array_equal(answers[0], want_v1)
    assert np.array_equal(answers[-1], want_v2)


def test_rolling_deploy_rollback_on_regression(lowrank, fitted, tmp_path):
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    ckpt = str(tmp_path / "deploy_ckpts")
    shutil.copytree(fitted["ckpt"], ckpt)
    store = TensorStore(grown)
    with _boot(ckpt, store=store, config=_config()) as svc:
        rng = np.random.default_rng(6)
        bad = {"factors": [rng.standard_normal((s, RANK)).astype(np.float32)
                           for s in SHAPE],
               "lam": np.ones(RANK, np.float32),
               "fits": np.array([0.0])}
        CheckpointManager(ckpt).save(99, bad)
        event = svc.deploy_checkpoint()
        assert event["rolled_back"] and not event["published"]
        assert svc.engine.version == 1
        assert event["sample_fit_candidate"] < event["sample_fit_current"]
        assert svc.metrics.counter("rollbacks_total") == 1
        good_step = fitted["result"].sweeps
        event2 = svc.deploy_checkpoint(step=good_step)
        assert event2["published"] and svc.engine.version == 2


def test_export_snapshot_hook(fitted):
    store = TensorStore(fitted["store_path"])
    with _solver(store, _config()) as solver:
        solver.run(2)
        snap = solver.export_snapshot(version=7, source="unit test")
    assert isinstance(snap, FactorSnapshot)
    assert snap.version == 7 and snap.shape == SHAPE and snap.rank == RANK
    assert snap.device.type == "cpu"
    res = solver.result()
    for f, g in zip(snap.host_factors(), res.factors):
        np.testing.assert_array_equal(f, np.asarray(g, np.float32))


# -- the card is the default ------------------------------------------------

def test_snapshot_defaults_to_the_card():
    """Without ``device=`` a snapshot goes to the card; with no card that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FactorSnapshot.from_arrays([np.ones((2, 1), np.float32)],
                                   np.ones(1, np.float32), version=1)


# -- cross-package ----------------------------------------------------------

@pytest.fixture(scope="module")
def jfitted(lowrank, fitted, tmp_path_factory):
    """The reference package's 10-sweep fit of the same base store, with
    its own checkpoint directory."""
    import repro.api as japi
    from repro.api.config import DecomposeConfig as JConfig
    from repro.api.config import RuntimeConfig as JRuntime
    from repro.store import TensorStore as JStore
    ckpt = str(tmp_path_factory.mktemp("jserve") / "ckpts")
    cfg = JConfig(rank=RANK, runtime=JRuntime(
        num_devices=1, tol=0.0, seed=0, checkpoint_dir=ckpt))
    with japi.compile(japi.plan(JStore(fitted["store_path"]), cfg),
                      cfg) as solver:
        result = solver.run(10)
    return {"ckpt": ckpt, "result": result}


def test_reference_checkpoint_boots_port_service(jfitted):
    """Within 1e-5 relative of the reference engine (both fp32, summed in
    a different order), on the reference's own checkpoint."""
    from repro.serve import CPService as JService
    rng = np.random.default_rng(7)
    coords = np.stack([rng.integers(0, s, size=100) for s in SHAPE], axis=1)
    with JService.boot(jfitted["ckpt"]) as jsvc:
        want = jsvc.reconstruct(coords)
    with _boot(jfitted["ckpt"]) as svc:
        got = svc.reconstruct(coords)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_incremental_refit_matches_reference(lowrank, fitted, tmp_path):
    """One grown store, one seed, one base snapshot: the two packages'
    sweep fits and published fit agree within 1e-4."""
    from repro.api.config import DecomposeConfig as JConfig
    from repro.api.config import RuntimeConfig as JRuntime
    from repro.serve import FactorSnapshot as JSnapshot
    from repro.serve import affected_row_masks as j_masks
    from repro.serve import incremental_refit as j_refit
    from repro.store import TensorStore as JStore
    from repro_torch.serve import affected_row_masks, incremental_refit
    t, base_n = lowrank
    grown = _copy_store(fitted, tmp_path)
    append_to_store(grown, t.indices[base_n:].astype(np.int64),
                    t.values[base_n:])
    payload, _ = CheckpointManager(fitted["ckpt"]).restore_latest()
    store, jstore = TensorStore(grown), JStore(grown)
    delta = {"old_nnz": base_n}
    snap, info = incremental_refit(
        store, _config(), FactorSnapshot.from_arrays(
            payload["factors"], payload["lam"], version=1, device=CPU),
        sweeps=3, masks=affected_row_masks(store, delta))
    jsnap, jinfo = j_refit(
        jstore, JConfig(rank=RANK, runtime=JRuntime(num_devices=1, tol=0.0,
                                                    seed=0)),
        JSnapshot.from_arrays(payload["factors"], payload["lam"],
                              version=1),
        sweeps=3, masks=j_masks(jstore, delta))
    np.testing.assert_allclose(info["sweep_fits"], jinfo["sweep_fits"],
                               rtol=0, atol=1e-4)
    assert abs(info["fit"] - jinfo["fit"]) < 1e-4
    assert info["affected_rows"] == jinfo["affected_rows"]
    assert snap.version == jsnap.version == 2


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


def test_metrics_report_key_tree_matches_reference(fitted, jfitted):
    """The same lifecycle (boot, batched reconstructs, a top-k) gives the
    same key tree in both packages' ``metrics_report``."""
    from repro.serve import CPService as JService
    rng = np.random.default_rng(8)
    coords = np.stack([rng.integers(0, s, size=20) for s in SHAPE], axis=1)
    reports = []
    for svc in (JService.boot(jfitted["ckpt"]), _boot(fitted["ckpt"])):
        with svc:
            svc.reconstruct(coords)
            svc.topk(coords[0], mode=1, k=3)
            reports.append(svc.metrics_report())
    assert _key_tree(reports[0]) == _key_tree(reports[1])


def test_cli_once_prints_reference_keys(fitted, jfitted, capsys):
    """``python -m repro_torch.serve --once --device cpu`` prints a
    ``metrics_report`` line with the reference CLI's key tree."""
    from repro.serve.__main__ import main as jmain
    args = ["--ckpt", None, "--once", "--queries", "20", "--topk", "4"]
    args[1] = jfitted["ckpt"]
    assert jmain(args) == 0
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("metrics_report ")][-1]
    args[1] = fitted["ckpt"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve", *args,
                          "--device", "cpu"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("metrics_report ")][-1]
    got = json.loads(line[len("metrics_report "):])
    want = json.loads(jline[len("metrics_report "):])
    assert _key_tree(got) == _key_tree(want)
    assert got["counters"]["queries_total"] == \
        want["counters"]["queries_total"]
