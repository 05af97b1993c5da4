"""The port's EC (each kernel's plain PyTorch version, which is what a CPU
tensor runs) against the reference's Pallas kernels in interpret mode, on
the reference tests' own grids; plus the variant dispatch.

Tolerances: ``sorted`` and ``ref`` are bitwise — both packages add the same
f32 products in slot order. (All three of the port's kernels keep slot
order within a tile's run of at most ``CHUNK_BLOCKS`` blocks, which every
run of these grids is; longer runs are tests/test_torch_chunks.py's.)
``fused`` and ``blocked`` are held to the JAX kernels at 2e-4 (2e-2 for
bf16 rows), the reference's own tolerance for them: its one-hot matrix
product accumulates in another order than slot order. The port's
``blocked`` and ``fused`` sum in one order and give the same bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from _torch_cases import (BLOCKED_PROPERTY, BLOCKED_SHAPES,  # noqa: E402
                          DEGENERATE_SORTED, longest_run, blocked_case,
                          empty_shard_case, partitioned_case, shard_arrays)
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.mttkrp_pallas import ec_blocked as j_ec_blocked  # noqa: E402
from repro.kernels.ref import ec_rows_ref as j_ec_rows_ref  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.mttkrp_blocked import (RING_DEPTH,  # noqa: E402
                                                ec_blocked)
from repro_torch.kernels.ref import ec_rows_ref, mttkrp_dense_ref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4


def _both(part, factors, variant, dev=0, mode=1, num_buffers=2):
    """(reference in interpret mode, port on CPU) for one shard."""
    a = shard_arrays(part, dev)
    # the premise of the bitwise tests: every run is one work item
    assert longest_run(a["block_to_tile"]) <= _build.CHUNK_BLOCKS
    kw = dict(mode=mode, num_rows=part.rows_max, tile=part.tile,
              block_p=part.block_p, variant=variant, num_buffers=num_buffers)
    j = j_ops.mttkrp_local(
        jnp.asarray(a["indices"]), jnp.asarray(a["values"]),
        jnp.asarray(a["local_rows"]), jnp.asarray(a["block_to_tile"]),
        [jnp.asarray(f) for f in factors], interpret=True,
        tile_mask=jnp.asarray(a["tile_visited"]),
        seg_starts=jnp.asarray(a["seg_starts"]),
        seg_rows=jnp.asarray(a["seg_rows"]), **kw)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    p = ops.mttkrp_local(
        t["indices"], t["values"], t["local_rows"], t["block_to_tile"],
        [torch.from_numpy(f) for f in factors], tile_mask=t["tile_visited"],
        seg_starts=t["seg_starts"], seg_rows=t["seg_rows"], **kw)
    return np.asarray(j), p.numpy()


# -- sorted: bitwise (test_sorted_kernel.py grids) ---------------------------

@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [8, 32])
def test_sorted_bitwise(nmodes, rank):
    part, factors = partitioned_case(nmodes, rank, seed=nmodes * 10 + rank)
    j, p = _both(part, factors, "sorted")
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("num_buffers", [2, 3, 4])
def test_sorted_num_buffers_bitwise(num_buffers):
    part, factors = partitioned_case(3, 16, seed=5)
    j, p = _both(part, factors, "sorted", num_buffers=num_buffers)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("case", sorted(DEGENERATE_SORTED))
def test_sorted_degenerate_bitwise(case):
    part, factors, mode, dev = DEGENERATE_SORTED[case]()
    j, p = _both(part, factors, "sorted", dev=dev, mode=mode)
    np.testing.assert_array_equal(p, j)
    if case == "empty_shard":
        np.testing.assert_array_equal(p, 0.0)


@pytest.mark.parametrize("nmodes", [3, 5])
def test_ref_bitwise(nmodes):
    part, factors = partitioned_case(nmodes, 16, seed=nmodes)
    j, p = _both(part, factors, "ref")
    np.testing.assert_array_equal(p, j)


def test_ec_rows_ref_bitwise():
    rng = np.random.default_rng(0)
    nnz, r, rows = 20_000, 16, 37
    vals = rng.normal(size=nnz).astype(np.float32)
    gathered = [rng.normal(size=(nnz, r)).astype(np.float32)
                for _ in range(3)]
    lr = rng.integers(0, rows, nnz).astype(np.int32)
    j = j_ec_rows_ref(jnp.asarray(vals), [jnp.asarray(g) for g in gathered],
                      jnp.asarray(lr), rows)
    p = ec_rows_ref(torch.from_numpy(vals),
                    [torch.from_numpy(g) for g in gathered],
                    torch.from_numpy(lr), rows)
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


# -- fused (test_kernels.py:157-221) -----------------------------------------

@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("rank", [8, 32])
def test_fused_matches_reference(nmodes, rank):
    part, factors = partitioned_case(nmodes, rank, seed=nmodes * 10 + rank,
                                     layout="blocked")
    j, p = _both(part, factors, "fused")
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("num_buffers", [2, 3, 4])
def test_fused_num_buffers(num_buffers):
    part, factors = partitioned_case(3, 16, seed=5, layout="blocked")
    j, p = _both(part, factors, "fused", num_buffers=num_buffers)
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_fused_matches_blocked():
    part, factors = partitioned_case(4, 16, seed=9, layout="blocked")
    j, p = _both(part, factors, "blocked")
    _, pf = _both(part, factors, "fused")
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pf, p, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", ["fused", "blocked"])
def test_onehot_empty_shard(variant):
    part, factors, mode, dev = empty_shard_case(layout="blocked")
    j, p = _both(part, factors, variant, dev=dev, mode=mode)
    np.testing.assert_array_equal(p, 0.0)
    np.testing.assert_array_equal(j, 0.0)


def test_fused_replicated_shards():
    part, factors = partitioned_case(3, 16, seed=3, num_devices=2,
                                     replication=2, layout="blocked")
    for dev in range(2):
        j, p = _both(part, factors, "fused", dev=dev)
        np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_fused_padding_blocks():
    part, factors = partitioned_case(3, 16, seed=11, nnz=37,
                                     layout="blocked")
    assert (part.values == 0).any()
    j, p = _both(part, factors, "fused")
    np.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


# -- blocked, called directly (test_kernels.py:37-91) ------------------------

def _blocked_both(b2t, rit, vals, gathered, *, tile, n_tiles, p, dtype):
    kw = dict(num_rows=n_tiles * tile, tile=tile, block_p=p)
    j = j_ec_blocked(jnp.asarray(vals).astype(dtype), jnp.asarray(rit),
                     jnp.asarray(b2t),
                     [jnp.asarray(g).astype(dtype) for g in gathered],
                     interpret=True, **kw)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out = ec_blocked(torch.from_numpy(vals).to(tdt), torch.from_numpy(rit),
                     torch.from_numpy(b2t),
                     [torch.from_numpy(g).to(tdt) for g in gathered], **kw)
    # the reference leaves unvisited tiles uninitialised: select them out
    visited = np.zeros(n_tiles, bool)
    visited[b2t] = True
    mask = np.repeat(visited, tile)[:, None]
    j = np.where(mask, np.asarray(j), 0.0)
    return j, out.numpy()


@pytest.mark.parametrize("tile,p,r,nin", BLOCKED_SHAPES)
def test_blocked_shape_sweep(tile, p, r, nin):
    case = blocked_case(7, tile, 5, p, r, nin, seed=1)
    j, got = _blocked_both(*case, tile=tile, n_tiles=5, p=p,
                           dtype=jnp.float32)
    np.testing.assert_allclose(got, j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_blocked_dtypes(dtype):
    case = blocked_case(4, 8, 3, 32, 16, 2, seed=2)
    j, got = _blocked_both(*case, tile=8, n_tiles=3, p=32, dtype=dtype)
    assert got.dtype == np.float32
    tol = 2e-2 if dtype == jnp.bfloat16 else TOL
    np.testing.assert_allclose(got, j, rtol=tol, atol=tol)


@pytest.mark.parametrize("seed,nblocks,n_tiles", BLOCKED_PROPERTY)
def test_blocked_property(seed, nblocks, n_tiles):
    case = blocked_case(nblocks, 8, n_tiles, 16, 8, 2, seed)
    j, got = _blocked_both(*case, tile=8, n_tiles=n_tiles, p=16,
                           dtype=jnp.float32)
    np.testing.assert_allclose(got, j, rtol=TOL, atol=TOL)


def test_dense_ref_matches_sparse_ref():
    from repro_torch.core.coo import random_sparse, to_dense
    t = random_sparse((9, 7, 5, 4), 80, seed=3)
    rng = np.random.default_rng(4)
    factors = [torch.from_numpy(rng.normal(size=(s, 6)).astype(np.float32))
               for s in t.shape]
    for mode in range(4):
        dense = mttkrp_dense_ref(torch.from_numpy(to_dense(t)), factors, mode)
        sparse = ops.mttkrp_local(
            torch.from_numpy(t.indices), torch.from_numpy(t.values),
            torch.from_numpy(t.indices[:, mode]), torch.zeros(0), factors,
            mode=mode, num_rows=t.shape[mode], tile=1, block_p=1,
            variant="ref")
        torch.testing.assert_close(sparse, dense, rtol=1e-4, atol=1e-4)


# -- dispatch ----------------------------------------------------------------

def test_variant_precedence(monkeypatch):
    monkeypatch.delenv(ops.ENV_VARIANT, raising=False)
    assert ops.resolve_variant() == ops.DEFAULT_VARIANT == "blocked"
    assert ops.resolve_variant(use_kernel=False) == "ref"
    monkeypatch.setenv(ops.ENV_VARIANT, "sorted")
    assert ops.resolve_variant() == "sorted"
    assert ops.resolve_variant("fused") == "fused"
    assert ops.resolve_variant(use_kernel=False) == "ref"
    assert ops.resolve_variant("fused", use_kernel=False) == "fused"
    for v in ("ref", "blocked", "fused", "sorted"):
        assert ops.resolve_variant(v) == j_ops.resolve_variant(v)


def test_unknown_variant_raises(monkeypatch):
    with pytest.raises(ValueError, match="unknown EC variant"):
        ops.resolve_variant("onehot")
    monkeypatch.setenv(ops.ENV_VARIANT, "nope")
    with pytest.raises(ValueError, match="unknown EC variant"):
        ops.resolve_variant()


def test_sorted_without_descriptors_raises():
    part, factors = partitioned_case(3, 8, seed=1)
    a = {k: torch.from_numpy(v) for k, v in shard_arrays(part).items()}
    with pytest.raises(ValueError, match="segment descriptors"):
        ops.mttkrp_local(a["indices"], a["values"], a["local_rows"],
                         a["block_to_tile"],
                         [torch.from_numpy(f) for f in factors], mode=1,
                         num_rows=part.rows_max, tile=part.tile,
                         block_p=part.block_p, variant="sorted")


@pytest.mark.parametrize("variant", ["sorted", "fused", "blocked"])
def test_kernel_args_drive_the_wrapper_as_dispatch_does(variant):
    """``kernel_args`` is what both ``mttkrp_local`` and the smoke's
    full-size parity phase feed each wrapper."""
    from repro_torch.kernels.mttkrp_fused import ec_fused
    from repro_torch.kernels.mttkrp_sorted import ec_sorted
    kernel = {"sorted": ec_sorted, "fused": ec_fused,
              "blocked": ec_blocked}[variant]
    part, factors = partitioned_case(3, 8, seed=2)
    a = {k: torch.from_numpy(v) for k, v in shard_arrays(part).items()}
    facs = [torch.from_numpy(f) for f in factors]
    arrays = (a["indices"], a["values"], a["local_rows"], a["block_to_tile"],
              facs)
    seg = dict(seg_starts=a["seg_starts"], seg_rows=a["seg_rows"])
    geo = dict(num_rows=part.rows_max, tile=part.tile, block_p=part.block_p)
    args = ops.kernel_args(variant, *arrays, mode=1, tile=part.tile, **seg)
    got = kernel(*args, **geo)
    want = ops.mttkrp_local(*arrays, mode=1, variant=variant,
                            tile_mask=a["tile_visited"], **geo, **seg)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="launches no kernel"):
        ops.kernel_args("ref", *arrays, mode=1, tile=part.tile)


def test_unvisited_tile_nan_is_selected_to_zero():
    out = torch.ones(24, 3)
    out[8:16] = float("nan")
    got = ops._mask_unvisited(out, torch.tensor([1.0, 0.0, 1.0]), 8)
    assert torch.isfinite(got).all()
    assert (got[8:16] == 0).all() and (got[:8] == 1).all()


def test_kernel_kwargs_and_autotune(monkeypatch):
    from repro_torch.api.config import KernelConfig
    monkeypatch.delenv(ops.ENV_VARIANT, raising=False)
    assert ops.kernel_kwargs_from_config(KernelConfig()) == dict(
        use_kernel=False, variant="ref", num_buffers=2)
    assert ops.kernel_kwargs_from_config(KernelConfig(
        use_kernel=True, variant="sorted", num_buffers=3)) == dict(
        use_kernel=True, variant="sorted", num_buffers=3)
    # the autotuner is ported: with both packages' tuners patched to one
    # winner, the ring depth resolves as the reference resolves it
    # (explicit > tuned > default; no problem key: the default)
    from repro.api.config import KernelConfig as JKernelConfig
    from repro.kernels import autotune as j_at
    from repro_torch.kernels import autotune as t_at
    monkeypatch.setattr(j_at, "autotune_ec",
                        lambda *a, **k: j_at.ECConfig(16, 64, 3))
    monkeypatch.setattr(t_at, "autotune_ec",
                        lambda *a, **k: t_at.ECConfig(16, 64, 3))
    for kw in (dict(variant="fused"), dict(variant="sorted"),
               dict(variant="fused", num_buffers=4), dict(variant="ref")):
        for key in (dict(nmodes=3, rank=8), {}):
            got = ops.kernel_kwargs_from_config(KernelConfig(
                use_kernel=True, autotune=True, **kw), device="cpu", **key)
            want = j_ops.kernel_kwargs_from_config(JKernelConfig(
                use_kernel=True, autotune=True, **kw), **key)
            assert got == want


def test_smem_model_and_limit():
    kw = dict(tile=8, rank=32)
    assert ops.variant_smem_bytes("ref", **kw) == 0
    # every kernel: 4 warps, each a ring of 2 stages of 8 slots of 2 rows,
    # the stages' values, the metadata (2 blocks of 2*8+3 descriptor words,
    # or 2 stages of 8 rows in tile, 16-byte rounded) and the tile
    ring = dict(nin=2, num_buffers=2)
    assert ops.variant_smem_bytes("sorted", **kw, **ring) == \
        4 * 4 * (2 * 8 * 2 * 32 + 16 + 40 + 8 * 32)
    assert ops.variant_smem_bytes("fused", **kw, **ring) == \
        4 * 4 * (2 * 8 * 2 * 32 + 16 + 16 + 8 * 32)
    # blocked lays out fused's region: its ring holds the pre-gathered rows
    # in f32 and it stages no index word
    assert ops.variant_smem_bytes("blocked", **kw, **ring) == \
        ops.variant_smem_bytes("fused", **kw, **ring)
    assert ops.variant_smem_bytes("blocked", tile=8, rank=32, nin=3,
                                  num_buffers=RING_DEPTH) == \
        4 * 4 * (RING_DEPTH * 8 * (3 * 32 + 2) + 8 * 32)
    # every case of the tested range fits
    for variant in ("sorted", "fused", "blocked"):
        assert ops.variant_smem_bytes(variant, tile=8, rank=64, nin=4,
                                      num_buffers=4) < ops.SMEM_LIMIT
        assert ops.variant_smem_bytes(variant, tile=32, rank=128, nin=4,
                                      num_buffers=4) > ops.SMEM_LIMIT
        with pytest.raises(ValueError, match="nin and num_buffers"):
            ops.variant_smem_bytes(variant, **kw)
    b2t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        _build.item_buffers("sorted", b2t, num_rows=32, tile=32, rank=128,
                            nin=4, num_buffers=4)
    with pytest.raises(ValueError, match="shared memory"):
        _build.item_buffers("blocked", b2t, num_rows=64, tile=64, rank=128,
                            nin=4, num_buffers=RING_DEPTH)
    with pytest.raises(ValueError, match="R <= 128"):
        _build.item_buffers("fused", b2t, num_rows=8, tile=8, rank=256,
                            nin=1, num_buffers=2)


def test_wrappers_run_plain_version_on_cpu_without_launching():
    part, factors = partitioned_case(3, 8, seed=2)
    before = dict(_build.LAUNCHES)
    for variant in ("sorted", "fused", "blocked"):
        _both(part, factors, variant)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("b2t,expect", [
    ([0, 0, 3, 3, 3, 4, 7, 7], [0, 2, 5, 6, 8, 8, 8, 8, 8]),
    ([5], [0, 1]),
    ([], [0]),
    ([1, 1, 1], [0, 3, 3, 3]),
])
def test_tile_runs(b2t, expect):
    got = _build.tile_runs(torch.tensor(b2t, dtype=torch.int32))
    assert got.dtype == torch.int32
    assert got.tolist() == expect


def test_isolation_from_jax_and_the_reference():
    """The port and chip_smoke.py import neither jax nor anything of the
    reference package: every module of the port, the serving and analysis
    packages among them, and the smoke's own imports."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "import repro_torch.serve, repro_torch.analysis\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):"
        "\n    importlib.import_module(m.name)\n"
        "assert {'repro_torch.serve.service', 'repro_torch.serve.__main__',"
        " 'repro_torch.analysis.hlo_audit',"
        " 'repro_torch.analysis.__main__'} <= set(sys.modules)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
