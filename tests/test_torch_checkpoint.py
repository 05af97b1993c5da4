"""The port's checkpoint manager and solver checkpoints on the CPU.

Twins of tests/test_checkpoint.py (round trip, retention, corruption
fallback, partial write, the async hand-off and its error in ``wait()``,
manifest integrity), plus: checkpoints cross between the packages in both
directions, bitwise (one on-disk format); ``CPSolver.checkpoint`` /
``restore`` in the port continue a run within 1e-6 (fits) and 1e-5
(factors), the tolerances of tests/test_api.py's round trip; a checkpoint
written by the reference solver restores into the port's solver and its
continued fits are within 1e-4 of the reference's own resumed run (the
cross-package tolerance of tests/test_torch_als.py: the two packages'
eigh and matmul round differently); and the elastic case, 4 → 2 logical
CPU devices, with tests/test_api_elastic.py's assertions.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.api as japi  # noqa: E402
from repro.training.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
import repro_torch.api as api  # noqa: E402
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
from repro_torch.core.mttkrp import cp_mesh  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                       "b": rng.normal(size=(3,)).astype(np.float32)},
            "opt": [rng.normal(size=(2,)), rng.normal(size=(2,))],
            "step": np.asarray(7)}


def _assert_payload_equal(got, want):
    np.testing.assert_array_equal(got["params"]["w"], want["params"]["w"])
    np.testing.assert_array_equal(got["params"]["b"], want["params"]["b"])
    assert isinstance(got["opt"], list) and len(got["opt"]) == 2
    for a, b in zip(got["opt"], want["opt"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(got["step"], want["step"])


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = _payload()
    mgr.save(3, p)
    got, step = mgr.restore_latest()
    assert step == 3
    _assert_payload_equal(got, p)


def test_torch_tensors_are_saved_from_the_host(tmp_path):
    """A payload of torch tensors is written as their host arrays."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    p = _payload(2)
    t = {"params": {k: torch.from_numpy(v.copy())
                    for k, v in p["params"].items()},
         "opt": [torch.from_numpy(v.copy()) for v in p["opt"]],
         "step": p["step"]}
    mgr.save(1, t, block=False)
    t["params"]["w"].fill_(-1.0)  # the hand-off copied on this thread
    mgr.wait()
    got, _ = mgr.restore_latest()
    _assert_payload_equal(got, p)


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _payload(s))
    assert mgr.steps() == [3, 4]


def test_corruption_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _payload(1))
    mgr.save(2, _payload(2))
    d = mgr._step_dir(2)
    victim = next(f for f in os.listdir(d) if f.endswith(".npy"))
    with open(os.path.join(d, victim), "wb") as f:
        f.write(b"garbage")
    got, step = mgr.restore_latest()
    assert step == 1  # fell back past the corrupted checkpoint
    _assert_payload_equal(got, _payload(1))
    assert mgr.restore(2) is None


def test_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _payload(1))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    got, step = mgr.restore_latest()
    assert step == 1
    assert mgr.steps() == [1]


def test_async_handoff_semantics(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, _payload(1), block=False)
    assert mgr._thread is not None          # handed off, not inline
    mgr.wait()
    assert mgr._thread is None
    mgr.save(2, _payload(2), block=True)    # block=True: sync even when
    assert mgr._thread is None              # async_save=True
    sync = CheckpointManager(str(tmp_path), async_save=False)
    sync.save(3, _payload(3), block=False)  # async_save=False: always sync
    assert sync._thread is None
    assert mgr.steps() == [1, 2, 3]
    got, _ = mgr.restore_latest()
    _assert_payload_equal(got, _payload(3))


def test_async_caller_mutation_safe(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    p = _payload(4)
    mgr.save(1, p, block=False)
    p["params"]["w"][:] = -1.0
    mgr.wait()
    got, _ = mgr.restore_latest()
    _assert_payload_equal(got, _payload(4))


def test_async_save_error_surfaces_in_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    with open(os.path.join(str(tmp_path), "step_0000000005.tmp"), "w"):
        pass
    mgr.save(5, _payload(5), block=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # cleared: does not re-raise
    assert mgr.steps() == []
    with open(os.path.join(str(tmp_path), "step_0000000006.tmp"), "w"):
        pass
    mgr.save(6, _payload(6), block=False)
    with pytest.raises(OSError):
        mgr.save(7, _payload(7), block=False)
    mgr.wait()


def test_manifest_integrity_recorded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, _payload())
    man = json.load(open(os.path.join(mgr._step_dir(4), "manifest.json")))
    assert man["step"] == 4
    assert all("sha256" in v for v in man["arrays"].values())
    assert man["arrays"]["params/w"]["file"] == "params__w.npy"


@pytest.mark.parametrize("writer,reader", [
    (JCheckpointManager, CheckpointManager),
    (CheckpointManager, JCheckpointManager),
], ids=["reference_to_port", "port_to_reference"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer, reader):
    """One on-disk format: what either manager writes, the other
    restores, bitwise — also the corruption fallback."""
    w = writer(str(tmp_path), keep=5)
    w.save(1, _payload(1))
    w.save(2, _payload(2))
    files = sorted(os.listdir(w._step_dir(2)))
    r = reader(str(tmp_path))
    got, step = r.restore_latest()
    assert step == 2
    _assert_payload_equal(got, _payload(2))
    victim = next(f for f in files if f.endswith(".npy"))
    with open(os.path.join(w._step_dir(2), victim), "wb") as f:
        f.write(b"garbage")
    got, step = r.restore_latest()
    assert step == 1
    _assert_payload_equal(got, _payload(1))


def test_identical_files_from_both_managers(tmp_path):
    """The two managers write the same array files, byte for byte (the
    manifests differ only in their time stamps)."""
    JCheckpointManager(str(tmp_path / "j")).save(3, _payload(3))
    CheckpointManager(str(tmp_path / "t")).save(3, _payload(3))
    dj = tmp_path / "j" / "step_0000000003"
    dt = tmp_path / "t" / "step_0000000003"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for name in os.listdir(dj):
        if name.endswith(".npy"):
            assert (dj / name).read_bytes() == (dt / name).read_bytes()
    mj = json.load(open(dj / "manifest.json"))
    mt = json.load(open(dt / "manifest.json"))
    assert mj["arrays"] == mt["arrays"] and mj["step"] == mt["step"]


# -- solver checkpoints ------------------------------------------------------

def _port_tensor(t):
    return SparseTensor(t.indices, t.values, t.shape)


def _cfg(pkg, ckpt, **over):
    return pkg.preset("paper", {"rank": 8, "runtime.num_devices": 1,
                                "runtime.tol": 0.0, "runtime.seed": 3,
                                "runtime.checkpoint_dir": str(ckpt), **over})


def test_solver_checkpoint_restore_continues(small_tensor, tmp_path):
    """4 sweeps checkpointed every sweep; a fresh solver restored at sweep
    2 runs to 4 within 1e-6 (fits) and 1e-5 (factors) of the
    uninterrupted run, and the restored factors are the saved ones."""
    t = _port_tensor(small_tensor)
    cfg = _cfg(api, tmp_path / "ck")
    plan = api.plan(t, cfg, device="cpu")
    with api.compile(plan, cfg, device="cpu") as s:
        full = s.run(4)
        saved = s._ckpt_mgr.restore(2)
    assert s._ckpt_mgr.steps() == [2, 3, 4]  # keep-3 retention
    with api.compile(plan, cfg, device="cpu") as s2:
        assert s2.restore(2)
        assert s2.state.sweep == 2
        for got, want in zip(s2.result().factors, saved["factors"]):
            np.testing.assert_array_equal(got, want)
        resumed = s2.run(4)
    np.testing.assert_allclose(resumed.fits, full.fits, atol=1e-6)
    for a, b in zip(resumed.factors, full.factors):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_solver_restore_latest_and_without_dir(small_tensor, tmp_path):
    t = _port_tensor(small_tensor)
    cfg = _cfg(api, tmp_path / "ck")
    plan = api.plan(t, cfg, device="cpu")
    with api.compile(plan, cfg, device="cpu") as s:
        assert not s.restore()  # nothing saved yet
        full = s.run(3)
    with api.compile(plan, cfg, device="cpu") as s:
        assert s.restore() and s.state.sweep == 3
        assert s.run(3).fits == full.fits
    bare = api.preset("paper", {"rank": 8, "runtime.num_devices": 1})
    with api.compile(plan, bare, device="cpu") as s:
        with pytest.raises(ValueError, match="checkpoint_dir"):
            s.restore()
        with pytest.raises(ValueError, match="checkpoint_dir"):
            s.checkpoint()


def test_solver_restore_refuses_a_mismatched_rank(small_tensor, tmp_path):
    t = _port_tensor(small_tensor)
    cfg = _cfg(api, tmp_path / "ck")
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        s.run(1)
    cfg4 = _cfg(api, tmp_path / "ck", rank=4)
    with api.compile(api.plan(t, cfg4, device="cpu"), cfg4,
                     device="cpu") as s:
        with pytest.raises(ValueError, match="rank 8"):
            s.restore()


def test_reference_checkpoint_resumes_in_the_port(small_tensor, tmp_path):
    """The reference solver checkpoints 2 sweeps; the port's solver
    restores them and runs to 5, within 1e-4 of the reference's own
    resumed run; the restored factors are the reference's bits."""
    ck = tmp_path / "ck"
    jcfg = _cfg(japi, ck)
    japi.compile(japi.plan(small_tensor, jcfg), jcfg).run(2)
    saved = JCheckpointManager(str(ck)).restore(2)
    shutil.copytree(ck, tmp_path / "ck_port")  # each resumed run writes on
    j2 = japi.compile(japi.plan(small_tensor, jcfg), jcfg)
    assert j2.restore()
    j_fits = j2.run(5).fits

    cfg = _cfg(api, tmp_path / "ck_port")
    with api.compile(api.plan(_port_tensor(small_tensor), cfg,
                              device="cpu"), cfg, device="cpu") as s:
        assert s.restore() and s.state.sweep == 2
        for got, want in zip(s.result().factors, saved["factors"]):
            np.testing.assert_array_equal(got, want)
        t_fits = s.run(5).fits
    assert t_fits[:2] == list(saved["fits"])
    np.testing.assert_allclose(t_fits, j_fits, atol=1e-4)


def test_port_checkpoint_resumes_in_the_reference(small_tensor, tmp_path):
    """The other direction: the port's checkpoint restores into the
    reference solver, bitwise, and both continue within 1e-4."""
    ck = tmp_path / "ck"
    cfg = _cfg(api, ck)
    t = _port_tensor(small_tensor)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        s.run(2)
    saved = CheckpointManager(str(ck)).restore(2)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        assert s.restore()
        t_fits = s.run(4).fits  # writes sweeps 3-4 beside sweep 2
    jcfg = _cfg(japi, ck)
    j = japi.compile(japi.plan(small_tensor, jcfg), jcfg)
    assert j.restore(2) and j.state.sweep == 2
    for got, want in zip(j.result().factors, saved["factors"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(j.run(4).fits, t_fits, atol=1e-4)


def test_elastic_restore_4_to_2_logical_devices(tmp_path):
    """tests/test_api_elastic.py in the port: 3 sweeps on 4 logical CPU
    devices, checkpointed every sweep; restored into a solver for 2, whose
    plan (another ownership layout, another cache entry) comes from the
    same plan cache; its first three fits are the 4-device run's and it
    goes on rising."""
    t = random_sparse((50, 37, 24), 800, seed=1, distribution="zipf")
    ck, plans = str(tmp_path / "ck"), str(tmp_path / "plans")
    base = {"rank": 6, "runtime.tol": 0.0, "runtime.seed": 5,
            "runtime.checkpoint_dir": ck}
    cfg4 = api.preset("paper", {**base, "runtime.num_devices": 4})
    cfg2 = api.preset("paper", {**base, "runtime.num_devices": 2})
    api.reset_cache_stats()
    p4 = api.plan(t, cfg4, cache_dir=plans, device="cpu")
    with api.compile(p4, cfg4, mesh=cp_mesh(4, p4.modes[0].r,
                                            devices=["cpu"] * 4)) as s4:
        fits4 = s4.run(3).fits
    p2 = api.plan(t, cfg2, cache_dir=plans, device="cpu")
    with api.compile(p2, cfg2, mesh=cp_mesh(2, p2.modes[0].r,
                                            devices=["cpu"] * 2)) as s2:
        assert s2.restore()
        assert s2.state.sweep == 3
        fits2 = s2.run(6).fits
    assert fits2[:3] == pytest.approx(fits4, abs=1e-6)
    assert len(fits2) == 6 and fits2[3] >= fits4[-1] - 1e-3
    assert all(b >= a - 1e-4 for a, b in zip(fits2[3:], fits2[4:]))
    assert api.CACHE_STATS == {"hits": 0, "misses": 2}
