"""The port's tensor store (``repro_torch.store``) on the CPU, against the
reference's ``repro.store``.

The on-disk format is the reference's: a store written by either package
has the same bytes and is read by the other, bitwise. Planning from the
store's statistics gives the reference's layouts, per-device shards,
super-shard windows and window arrays (mid-chunk window boundaries
included), bitwise, with zero chunk reads; the byte model and the
migration cap equal the reference's.
"""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import store as jst  # noqa: E402
from repro.core.coo import random_sparse as j_random_sparse  # noqa: E402
from repro.sparse.io import write_tns  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch import store as tst  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.core.partition import build_plan  # noqa: E402
from repro_torch.store import convert as t_convert  # noqa: E402

FILES_ARRAYS = ("indices", "values", "local_rows")


@pytest.fixture(scope="module")
def zipf():
    return j_random_sparse((200, 60, 30), 5000, seed=3, distribution="zipf",
                           dedup=False)


@pytest.fixture(scope="module")
def stores(zipf, tmp_path_factory):
    """The same tensor written by each package (chunk 512)."""
    root = tmp_path_factory.mktemp("stores")
    paths = {"ref": str(root / "ref.store"), "port": str(root / "port.store")}
    jst.write_store_from_coo(zipf, paths["ref"], chunk_nnz=512)
    tst.write_store_from_coo(SparseTensor(zipf.indices, zipf.values,
                                          zipf.shape), paths["port"],
                             chunk_nnz=512)
    return paths


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_store_bytes_equal_and_cross_readable(stores, zipf):
    _same_dirs(stores["ref"], stores["port"])
    for jpath, tpath in ((stores["port"], stores["ref"]),
                         (stores["ref"], stores["port"])):
        js, ts = jst.TensorStore(jpath), tst.TensorStore(tpath)
        assert js.digest == ts.digest and js.shape == ts.shape
        assert js.num_chunks == ts.num_chunks == 10
        for k in range(ts.num_chunks):
            (ji, jv), (ti, tv) = js.read_chunk(k), ts.read_chunk(k)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tv.view(np.int32),
                                          jv.view(np.int32))
        for d in range(3):
            np.testing.assert_array_equal(ts.mode_histogram(d),
                                          js.mode_histogram(d))
        assert ts.norm() == js.norm()
        back = ts.to_coo()
        np.testing.assert_array_equal(back.indices, zipf.indices)
        np.testing.assert_array_equal(back.values, zipf.values)
        assert ts.chunks_overlapping(0, 10, 20) == \
            js.chunks_overlapping(0, 10, 20)


def test_profile_and_tns_stores_equal(zipf, tmp_path):
    for pkg, name in ((jst, "j"), (tst, "t")):
        pkg.write_profile_store("amazon", str(tmp_path / f"{name}.prof"),
                                scale=2e-5, seed=1, chunk_nnz=4096)
    _same_dirs(str(tmp_path / "j.prof"), str(tmp_path / "t.prof"))
    tns = str(tmp_path / "x.tns")
    write_tns(tns, zipf)
    jst.convert_tns(tns, str(tmp_path / "j.cvt"), chunk_nnz=700)
    t_convert.main([tns, str(tmp_path / "t.cvt"), "--chunk-nnz", "700"])
    _same_dirs(str(tmp_path / "j.cvt"), str(tmp_path / "t.cvt"))


def test_append_and_refresh_match_reference(zipf, tmp_path):
    out = {}
    for pkg, name in ((jst, "j"), (tst, "t")):
        path = str(tmp_path / name)
        pkg.write_store_from_coo(zipf, path, chunk_nnz=700)
        reader = pkg.TensorStore(path)
        pkg.append_to_store(path, zipf.indices[:300].astype(np.int64),
                            zipf.values[:300])
        out[name] = reader.refresh()
    assert out["j"] == out["t"]
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))


@pytest.mark.parametrize("m,strategy,repl,layout", [
    (1, "amped_cdf", 1, "blocked"), (4, "amped_cdf", 1, "sorted"),
    (4, "amped_cdf", 2, "blocked"), (4, "equal_nnz", None, "sorted"),
    (4, "amped_lpt", None, "blocked")])
def test_plan_from_store_matches_reference(stores, zipf, m, strategy, repl,
                                           layout):
    js, ts = jst.TensorStore(stores["ref"]), tst.TensorStore(stores["port"])
    kw = dict(strategy=strategy, replication=repl, layout=layout)
    jp = jst.build_plan_from_store(js, m, **kw)
    ts.reset_access_stats()
    tp = tst.build_plan_from_store(ts, m, **kw)
    assert ts.access_stats["chunk_reads"] == 0
    assert tp.norm == jp.norm and tp.shape == jp.shape
    mem = build_plan(SparseTensor(zipf.indices, zipf.values, zipf.shape), m,
                     **kw)
    for w in range(3):
        np.testing.assert_array_equal(tp.global_to_padded[w],
                                      jp.global_to_padded[w])
        np.testing.assert_array_equal(tp.padded_to_global[w],
                                      jp.padded_to_global[w])
    for jm, tm, mm in zip(jp.modes, tp.modes, mem.modes, strict=True):
        assert tm.lazy and not mm.lazy
        for f in tm.META_FIELDS + ("nnz_max", "nblocks"):
            assert getattr(tm, f) == getattr(jm, f) == getattr(mm, f), f
        for f in ("block_to_tile", "tile_visited", "nnz_true",
                  "blocks_true", "rows_owned", "_dev_tc_pad"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
        assert tm.balance_stats() == jm.balance_stats()
        for dev in range(m):
            for name, a, b, c in zip(FILES_ARRAYS, tm.device_arrays(dev),
                                     jm.device_arrays(dev),
                                     (mm.indices[dev], mm.values[dev],
                                      mm.local_rows[dev])):
                np.testing.assert_array_equal(a, b, err_msg=name)
                np.testing.assert_array_equal(a, c, err_msg=name)


def _feasible_budget(parts, frac_of_total=0.33, buffers=2):
    """tests/test_streaming.py's budget: a fraction of the modes' resident
    shard bytes, never below a densest-tile or chunk-staging floor."""
    nmodes = parts[0].nmodes
    total = sum(tst.resident_shard_nbytes(p, nmodes) for p in parts)
    floors = []
    for p in parts:
        per_slot = 4 * nmodes + 8 + 4 / p.block_p
        dense = int(p._dev_tc_pad.max()) if p._dev_tc_pad.size else 0
        floors.append(buffers * int(max(dense, p.block_p) * per_slot
                                    + p.layout.n_tiles * 4 + 1))
        floors.append(p.store.chunk_nnz * (8 * nmodes + 4))
    return max(int(total * frac_of_total), *floors)


@pytest.mark.parametrize("m,strategy,repl,sort_mode", [
    (1, "amped_cdf", 1, 0), (4, "amped_cdf", 2, None),
    (4, "equal_nnz", None, None), (2, "amped_cdf", 1, 1)])
def test_super_shards_match_reference(zipf, tmp_path, m, strategy, repl,
                                      sort_mode):
    """Windows, caps and every window's five arrays, bitwise; on a
    mode-sorted store a window boundary falls inside a chunk, which two
    windows then both read."""
    t = zipf if sort_mode is None else zipf.sorted_by_mode(sort_mode)
    jst.write_store_from_coo(t, str(tmp_path / "j"), chunk_nnz=500)
    tst.write_store_from_coo(t, str(tmp_path / "t"), chunk_nnz=500)
    js, ts = jst.TensorStore(str(tmp_path / "j")), \
        tst.TensorStore(str(tmp_path / "t"))
    kw = dict(strategy=strategy, replication=repl)
    jp = jst.build_plan_from_store(js, m, **kw)
    tp = tst.build_plan_from_store(ts, m, **kw)
    budget = _feasible_budget(tp.modes)
    split = False
    for jm, tm in zip(jp.modes, tp.modes):
        jsp = jst.split_mode_super_shards(jm, budget)
        ts.reset_access_stats()
        tsp = tst.split_mode_super_shards(tm, budget)
        assert ts.access_stats["chunk_reads"] == 0
        for f in ("mode", "num_shards", "windows", "nnz_cap", "nblocks",
                  "n_tiles", "shard_bytes", "budget_bytes", "buffers"):
            assert getattr(tsp, f) == getattr(jsp, f), f
        assert tsp.resident_bound_bytes() == jsp.resident_bound_bytes()
        assert tsp.validate_against(tm, nmodes=3) == []
        split = split or tsp.num_shards > 1
        for dev in range(m):
            for k, (t0, t1) in enumerate(tsp.windows[dev]):
                a = tm.super_shard_arrays(dev, t0, t1, nnz_cap=tsp.nnz_cap,
                                          nblocks=tsp.nblocks)
                b = jm.super_shard_arrays(dev, t0, t1, nnz_cap=jsp.nnz_cap,
                                          nblocks=jsp.nblocks)
                for x, y in zip(a, b, strict=True):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    assert split
    if sort_mode == 0:
        # a boundary chunk is read by two consecutive windows
        part = tp.modes[0]
        sp = tst.split_mode_super_shards(part, budget)
        ts.reset_access_stats()
        for t0, t1 in sp.windows[0]:
            part.super_shard_arrays(0, t0, t1, nnz_cap=sp.nnz_cap,
                                    nblocks=sp.nblocks)
        assert ts.access_stats["chunk_reads"] > ts.num_chunks


@pytest.mark.parametrize("budget", [1 << 16, 1 << 20, 12345679])
@pytest.mark.parametrize("nmodes,n_tiles,block_p,buffers", [
    (3, 10, 128, 2), (4, 1000, 64, 3), (5, 7, 16, 1)])
def test_byte_model_and_slot_cap_match_reference(budget, nmodes, n_tiles,
                                                 block_p, buffers):
    kw = dict(nmodes=nmodes, n_tiles=n_tiles, block_p=block_p,
              buffers=buffers)
    assert tst.budget_slot_cap(budget, **kw) == \
        jst.budget_slot_cap(budget, **kw)
    cap = tst.budget_slot_cap(budget, **kw)
    assert tst.stream_shard_nbytes(cap, cap // block_p, n_tiles, nmodes) \
        == jst.stream_shard_nbytes(cap, cap // block_p, n_tiles, nmodes)
    assert buffers * tst.stream_shard_nbytes(
        cap, cap // block_p, n_tiles, nmodes) <= budget or cap == 0


def test_split_refuses_what_the_reference_refuses(stores):
    part = tst.build_plan_from_store(tst.TensorStore(stores["port"]),
                                     1).modes[0]
    with pytest.raises(ValueError, match="staging footprint"):
        tst.split_mode_super_shards(part, 512 * 28 - 1)
    with pytest.raises(ValueError, match="densest row tile"):
        tst.split_mode_super_shards(part, 512 * 28 + 256)
    with pytest.raises(tst.OutOfCoreError):
        part.values  # noqa: B018


def test_api_plan_takes_a_store(stores, zipf):
    ts = tst.TensorStore(stores["port"])
    ts.reset_access_stats()
    cfg = tapi.preset("sorted", {"kernel.autotune": False,
                                 "runtime.num_devices": 4})
    plan = tapi.plan(ts, cfg, device="cpu")
    assert ts.access_stats["chunk_reads"] == 0
    assert all(p.lazy and p.block_layout == "sorted" for p in plan.modes)
    mem = tapi.plan(SparseTensor(zipf.indices, zipf.values, zipf.shape), cfg,
                    device="cpu")
    for lp, mp in zip(plan.modes, mem.modes):
        assert lp.r == mp.r
        np.testing.assert_array_equal(lp.block_to_tile, mp.block_to_tile)
        np.testing.assert_array_equal(lp.materialize().local_rows,
                                      mp.local_rows)


def test_convert_cli_profile(tmp_path, capsys):
    t_convert.main(["amazon", str(tmp_path / "p.store"), "--profile",
                    "--scale", "2e-5", "--chunk-nnz", "4096"])
    out = capsys.readouterr().out
    assert "profile amazon@2e-05" in out and "chunks=9x4096" in out
    assert tst.TensorStore(str(tmp_path / "p.store")).nnz == 34836


def test_new_modules_import_no_jax_and_no_reference():
    """The store, the streamers and the autotuners load neither jax nor
    any module of the reference package."""
    import subprocess
    import sys
    repo = os.path.join(os.path.dirname(__file__), "..")
    code = ("import sys\n"
            "import repro_torch.store, repro_torch.store.convert\n"
            "import repro_torch.sparse.stream, repro_torch.kernels.autotune\n"
            "import repro_torch.comm.autotune\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
