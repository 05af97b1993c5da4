"""The BLCO-style baseline and the legacy entry points of the port, on the
CPU, against the reference.

``blco_like_streaming``: the port against the reference's on the same
tensor and factors with ``chunk=128``, within 2e-4 (the cross-package
tolerance of tests/test_torch_als.py) with the same chunk count, and both
against a float64 dense MTTKRP within 5e-4 (tests/test_mttkrp_als.py's
tolerance for the reference's baseline). ``cp_decompose``: bitwise the
staged port API on the same seed, its fits within 1e-4 of the reference's
``cp_decompose``, and its checkpoint resume within tests/test_mttkrp_als.py's
1e-6 / 1e-5. ``from_legacy_kwargs``, ``paper_config`` and the deprecated
``*_setup`` shims give the reference's config dicts; ``write_tns`` writes the
reference's bytes and ``make_lowrank_tensor`` the reference's arrays, bit
for bit.
"""
import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.configs import amped_paper as j_paper  # noqa: E402
from repro.core.baselines import blco_like_streaming as j_blco  # noqa: E402
from repro.core.decompose import cp_decompose as j_cp_decompose  # noqa: E402
from repro.sparse import io as j_io  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch.configs import amped_paper as t_paper  # noqa: E402
from repro_torch.core.baselines import blco_like_streaming  # noqa: E402
from repro_torch.core.coo import SparseTensor, to_dense  # noqa: E402
from repro_torch.core.decompose import cp_decompose  # noqa: E402
from repro_torch.core.mttkrp import cp_mesh  # noqa: E402
from repro_torch.sparse import io as t_io  # noqa: E402


def _port_tensor(t):
    return SparseTensor(t.indices, t.values, t.shape)


def _factors(t, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s, rank)).astype(np.float32) for s in t.shape]


def _dense_mttkrp(t, factors, mode):
    """float64 X_(mode) (⊙ of the other factors)."""
    dense = to_dense(_port_tensor(t)).astype(np.float64)
    letters = "ijk"
    spec = ",".join([letters] + [letters[w] + "r" for w in range(3)
                                 if w != mode]) + "->" + letters[mode] + "r"
    return np.einsum(spec, dense, *[np.asarray(f, np.float64)
                                    for w, f in enumerate(factors)
                                    if w != mode])


# -- the baseline --------------------------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2])
def test_blco_baseline_matches_the_reference(small_tensor, mode):
    t = small_tensor
    factors = _factors(t)
    j_out, j_times = j_blco(t, [jnp.asarray(f) for f in factors], mode,
                            chunk=128)
    out, times = blco_like_streaming(
        _port_tensor(t), [torch.from_numpy(f) for f in factors], mode,
        chunk=128, device="cpu")
    assert out.device.type == "cpu" and out.shape == (t.shape[mode], 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=2e-4,
                               atol=2e-4)
    assert times["chunks"] == j_times["chunks"] == -(-t.nnz // 128)
    assert times["h2d_s"] >= 0 and times["ec_s"] > 0
    dense = _dense_mttkrp(t, factors, mode)
    for got in (out.numpy(), np.asarray(j_out)):
        np.testing.assert_allclose(got, dense, rtol=5e-4, atol=5e-4)


def test_blco_baseline_one_chunk_and_default_device(small_tensor,
                                                    monkeypatch):
    """A chunk larger than the tensor is one padded chunk; without
    ``device`` the baseline wants the card and raises where there is none
    (no silent CPU fallback)."""
    t = _port_tensor(small_tensor)
    factors = [torch.from_numpy(f) for f in _factors(small_tensor)]
    out, times = blco_like_streaming(t, factors, 1, chunk=1 << 16,
                                     device="cpu")
    assert times["chunks"] == 1
    np.testing.assert_allclose(out.numpy(),
                               _dense_mttkrp(small_tensor,
                                             [f.numpy() for f in factors],
                                             1), rtol=5e-4, atol=5e-4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blco_like_streaming(t, factors, 1, chunk=128)


# -- cp_decompose ----------------------------------------------------------------

@pytest.mark.parametrize("variant", [None, "fused", "sorted"])
def test_cp_decompose_is_the_staged_api(small_tensor, variant):
    """The shim warns, then gives the staged API's bits; its fits are
    within 1e-4 of the reference's shim on the same seed."""
    t = _port_tensor(small_tensor)
    cfg = api.DecomposeConfig.from_legacy_kwargs(
        rank=8, num_devices=1, tol=0, seed=3, use_kernel=variant is not None,
        kernel_variant=variant)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg,
                     device="cpu") as s:
        staged = s.run(3)
    kw = dict(rank=8, num_devices=1, iters=3, tol=0, seed=3,
              use_kernel=variant is not None, kernel_variant=variant)
    with pytest.warns(DeprecationWarning, match="cp_decompose"):
        legacy = cp_decompose(t, device="cpu", **kw)
    assert staged.fits == legacy.fits
    for f1, f2 in zip(staged.factors, legacy.factors):
        np.testing.assert_array_equal(f1, f2)
    with pytest.warns(DeprecationWarning, match="cp_decompose"):
        ref = j_cp_decompose(small_tensor, **kw)
    np.testing.assert_allclose(legacy.fits, ref.fits, atol=1e-4)


def test_cp_decompose_on_a_mesh(small_tensor):
    """``mesh=`` (a CPMesh, in place of the reference's JAX mesh) sets the
    device count: 2 logical CPU devices, the staged API's bits."""
    t = _port_tensor(small_tensor)
    mesh = cp_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.warns(DeprecationWarning):
        legacy = cp_decompose(t, rank=4, mesh=mesh, iters=2, tol=0, seed=1,
                              replication=1)
    cfg = api.DecomposeConfig.from_legacy_kwargs(rank=4, num_devices=2,
                                                 tol=0, seed=1,
                                                 replication=1)
    with api.compile(api.plan(t, cfg, device="cpu"), cfg, mesh=mesh) as s:
        staged = s.run(2)
    assert legacy.fits == staged.fits
    assert legacy.plan.num_devices == 2
    with pytest.raises(ValueError, match="mesh or a device"):
        with pytest.warns(DeprecationWarning):
            cp_decompose(t, mesh=mesh, device="cpu")


def test_cp_decompose_resume(small_tensor, tmp_path):
    """tests/test_mttkrp_als.py's resume: 2 checkpointed sweeps, then a
    resumed call to 4, within 1e-6 (fits) / 1e-5 (factors) of 4 sweeps in
    one call."""
    t = _port_tensor(small_tensor)
    kw = dict(rank=4, num_devices=1, iters=4, tol=0, seed=3, device="cpu")
    with pytest.warns(DeprecationWarning):
        r_full = cp_decompose(t, **kw, checkpoint_dir=str(tmp_path / "a"))
        cp_decompose(t, **{**kw, "iters": 2},
                     checkpoint_dir=str(tmp_path / "b"))
        r_resumed = cp_decompose(t, **kw, checkpoint_dir=str(tmp_path / "b"),
                                 resume=True)
    np.testing.assert_allclose(r_full.fits, r_resumed.fits, atol=1e-6)
    for f1, f2 in zip(r_full.factors, r_resumed.factors):
        np.testing.assert_allclose(f1, f2, atol=1e-5)


# -- configs ---------------------------------------------------------------------

LEGACY_KWARGS = {
    "defaults": {},
    "kernel": {"rank": 16, "use_kernel": True, "kernel_variant": "fused",
               "num_buffers": 3, "autotune": True},
    "partition": {"num_devices": 4, "strategy": "equal_nnz",
                  "replication": 2, "ring": False},
    "runtime": {"tol": 0.0, "seed": 9, "checkpoint_dir": "ck"},
}


@pytest.mark.parametrize("kw", LEGACY_KWARGS.values(),
                         ids=LEGACY_KWARGS.keys())
def test_from_legacy_kwargs_equals_the_reference(kw):
    got = api.DecomposeConfig.from_legacy_kwargs(**kw)
    want = japi.DecomposeConfig.from_legacy_kwargs(**kw)
    assert got.to_dict() == want.to_dict()
    assert api.DecomposeConfig.from_json(want.to_json()) == got


@pytest.mark.parametrize("name", ["paper", "optimized", "fused"])
def test_paper_config_and_setup_shims_equal_the_reference(name):
    over = {"runtime.tol": 0.0}
    assert t_paper.paper_config(name, over).to_dict() == \
        j_paper.paper_config(name, over).to_dict()
    legacy = {"num_devices": 2, "kernel_variant": "ref", "ring": False}
    shim = f"{name}_setup"
    with pytest.warns(DeprecationWarning, match=shim):
        got = getattr(t_paper, shim)("twitch", **legacy)
    with pytest.warns(DeprecationWarning, match=shim):
        want = getattr(j_paper, shim)("twitch", **legacy)
    assert got.to_dict() == want.to_dict()
    assert (t_paper.RANK, t_paper.PAPER_DEVICES) == \
        (j_paper.RANK, j_paper.PAPER_DEVICES)
    with pytest.raises(ValueError, match="unknown dataset profile"):
        with pytest.warns(DeprecationWarning):
            getattr(t_paper, shim)("nope")


# -- sparse/io -------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".tns", ".tns.gz"])
def test_write_tns_writes_the_reference_bytes(small_tensor, tmp_path,
                                              suffix):
    """The same text, byte for byte (inside the gzip stream, whose header
    carries a time stamp), with several np.savetxt chunks; and read_tns
    gets the tensor back."""
    t = small_tensor
    jp, tp = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    j_io.write_tns(jp, t, chunk=256)
    t_io.write_tns(tp, _port_tensor(t), chunk=256)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(jp, "rb") as a, opener(tp, "rb") as b:
        assert a.read() == b.read()
    back = t_io.read_tns(tp)
    np.testing.assert_array_equal(back.indices, t.indices)
    np.testing.assert_array_equal(back.values, t.values)


@pytest.mark.parametrize("shape,rank,nnz,seed", [
    ((40, 30, 20), 4, 600, 0),
    ((64, 48, 32), 8, 3000, 5),
    ((20, 15, 12, 10), 3, 500, 2),
])
def test_make_lowrank_tensor_is_the_reference(shape, rank, nnz, seed):
    got = t_io.make_lowrank_tensor(shape, rank, nnz, seed=seed)
    want = j_io.make_lowrank_tensor(shape, rank, nnz, seed=seed)
    assert got.shape == want.shape
    for a, b in ((got.indices, want.indices), (got.values, want.values)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="rank"):
        t_io.make_lowrank_tensor((3, 40, 40), 4, 100)
