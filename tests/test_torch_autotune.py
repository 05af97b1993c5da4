"""The port's autotuners (``repro_torch.kernels.autotune``,
``repro_torch.comm.autotune``) on the CPU, against the reference's.

Held equal to the reference: the cache keys, the v1/v2/v3 cache
migration, the device-kind sanitising, the representative shard (bitwise)
and the chunk candidates. Inside the port: memo hit, disk hit and re-tune
on a grid mismatch; the ring axis collapsed for ``ref`` and ``blocked``;
the port's cache file kept apart from the reference's, byte for byte both
ways; and, with both tuners patched to one winner, the ``fused`` and
``sorted`` presets plan bitwise as the reference plans them.
"""
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.comm import autotune as j_xchg  # noqa: E402
from repro.kernels import autotune as j_at  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.comm import autotune as t_xchg  # noqa: E402
from repro_torch.core import mttkrp as t_dm  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.kernels import autotune as t_at  # noqa: E402

TINY_GRID = dict(nnz=512, tiles=(8,), block_ps=(64,), repeats=1)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Each package's cache in its own temp file; memos and counters
    cleared before and after."""
    paths = {"port": str(tmp_path / "port.json"),
             "ref": str(tmp_path / "ref.json")}
    monkeypatch.setenv(t_at.ENV_CACHE, paths["port"])
    monkeypatch.setenv(j_at.ENV_CACHE, paths["ref"])
    for memo in (t_at._MEMO, j_at._MEMO, t_xchg._MEMO, j_xchg._MEMO):
        memo.clear()
    t_at.reset_counters()
    yield paths
    for memo in (t_at._MEMO, j_at._MEMO, t_xchg._MEMO, j_xchg._MEMO):
        memo.clear()


@pytest.mark.parametrize("nmodes,rank,backend,variant,kind", [
    (3, 8, "cpu", "fused", "cpu"), (4, 32, "gpu", "sorted",
                                    "nvidia-h100-80gb-hbm3"),
    (5, 16, "tpu", "blocked", "tpu-v4"), (3, 64, "gpu", "ref", "x.y-z")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_key_matches_reference(nmodes, rank, backend, variant, kind,
                                     dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jax.numpy, dtype)
    assert t_at._cache_key(nmodes, rank, backend, variant, tdt, kind=kind) \
        == j_at._cache_key(nmodes, rank, backend, variant, jdt, kind=kind)
    assert t_at._V3_KEY_RE.match(t_at._cache_key(
        nmodes, rank, backend, variant, tdt, kind=kind))


V1 = {"3m_r8_cpu_fused": {"tile": 8}, "4m_r16_tpu_blocked": {"tile": 16},
      "junk": {}, "xchg_overlap_rows8_r4_m2_float32_cpu": {"chunk_rows": 4}}
V2 = {"_format": 2, "3m_r8_float32_cpu_fused": {"tile": 8},
      "3m_r8_bfloat16_tpu_sorted": {"tile": 16}, "3m_cpu": {}}
V3 = {"_format": 3, "3m_r8_float32_gpu_nvidia-h100-80gb-hbm3_fused":
      {"tile": 8}, "3m_r8_float32_cpu_cpu_ref": {"tile": 8}}


@pytest.mark.parametrize("cache", [V1, V2, V3, {**V1, **V2, **V3}, {}],
                         ids=["v1", "v2", "v3", "mixed", "empty"])
def test_migrate_cache_matches_reference(cache):
    got = t_at._migrate_cache(dict(cache))
    assert got == j_at._migrate_cache(dict(cache))
    assert t_at._migrate_cache(got) == got  # idempotent


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "cpu",
                                  "TPU v4", "NVIDIA_A100-SXM4 (40GB)", "  "])
def test_device_kind_sanitised_as_the_reference(name, monkeypatch):
    monkeypatch.setattr(j_at.jax, "devices", lambda: [
        types.SimpleNamespace(device_kind=name)])
    want = j_at.device_kind_tag()
    assert t_at._sanitize_kind(name) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert t_at.device_kind_tag("cuda") == want
    assert t_at.device_kind_tag("cpu") == "cpu"
    assert t_at.backend_tag("cuda") == "gpu"
    assert t_at.backend_tag("cpu") == "cpu"


def test_h100_key_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert t_at._cache_key(3, 32, "gpu", "sorted") == \
        "3m_r32_float32_gpu_nvidia-h100-80gb-hbm3_sorted"


@pytest.mark.parametrize("nmodes,nnz,tile,block_p,layout", [
    (3, 4096, None, None, "blocked"), (3, 4096, 16, 64, "sorted"),
    (4, 2048, 8, 128, "blocked"), (5, 1024, 16, 128, "sorted")])
def test_representative_shard_bitwise(nmodes, nnz, tile, block_p, layout):
    jt, jp = j_at.representative_shard(nmodes, nnz, tile, block_p,
                                       layout=layout)
    tt, tp = t_at.representative_shard(nmodes, nnz, tile, block_p,
                                       layout=layout)
    np.testing.assert_array_equal(tt.indices, jt.indices)
    np.testing.assert_array_equal(tt.values, jt.values)
    for f in ("indices", "values", "local_rows", "block_to_tile",
              "tile_visited", "nnz_true", "rows_owned", "blocks_true"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert (tp.tile, tp.block_p, tp.rows_max) == \
        (jp.tile, jp.block_p, jp.rows_max)


def test_memo_disk_hit_and_grid_mismatch_retune(caches):
    key = "3m_r8_float32_cpu_cpu_fused"
    c1 = t_at.autotune_ec(3, 8, variant="fused", device="cpu", **TINY_GRID)
    assert t_at.COUNTERS == {"memo_hits": 0, "cache_hits": 0, "misses": 1}
    assert set(c1.timings) == {"t8_p64_b2", "t8_p64_b3"}
    assert all(v > 0 for v in c1.timings.values())
    on_disk = json.load(open(caches["port"]))
    assert on_disk["_format"] == 3 and key in on_disk
    assert on_disk[key]["grid"] == {"nnz": 512, "tiles": [8],
                                    "block_ps": [64],
                                    "num_buffers_grid": [2, 3]}
    assert t_at.autotune_ec(3, 8, variant="fused", device="cpu",
                            **TINY_GRID) is c1
    assert t_at.COUNTERS["memo_hits"] == 1
    t_at._MEMO.clear()
    c2 = t_at.autotune_ec(3, 8, variant="fused", device="cpu", **TINY_GRID)
    assert t_at.COUNTERS["cache_hits"] == 1 and c2 == c1
    assert c2.timings == c1.timings
    # another grid never replays this winner: it re-tunes
    t_at.autotune_ec(3, 8, variant="fused", device="cpu",
                     **{**TINY_GRID, "block_ps": (64, 128)})
    assert t_at.COUNTERS["misses"] == 2
    assert json.load(open(caches["port"]))[key]["grid"]["block_ps"] == \
        [64, 128]


@pytest.mark.parametrize("variant", ["blocked", "ref", "sorted"])
def test_ring_axis_collapses_without_a_ring(caches, variant):
    cfg = t_at.autotune_ec(3, 8, variant=variant, device="cpu", **TINY_GRID)
    want = {"t8_p64_b2"} if variant in ("blocked", "ref") else \
        {"t8_p64_b2", "t8_p64_b3"}
    assert set(cfg.timings) == want


def test_tuner_on_the_card_without_one_raises(caches, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_at.autotune_ec(3, 8, variant="fused", **TINY_GRID)


def test_a_failing_candidate_raises(caches, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("candidate failed to launch")
    monkeypatch.setattr(t_at.kops, "mttkrp_local", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        t_at.autotune_ec(3, 8, variant="fused", device="cpu", **TINY_GRID)
    assert not os.path.exists(caches["port"])


def test_cache_files_kept_apart(caches, tmp_path, monkeypatch):
    """A port run leaves a reference cache byte for byte as it was (even
    one the reference would migrate), and a reference run leaves the
    port's; the default paths differ."""
    old = json.dumps(V1).encode()
    with open(caches["ref"], "wb") as f:
        f.write(old)
    t_at.autotune_ec(3, 8, variant="fused", device="cpu", **TINY_GRID)
    assert open(caches["ref"], "rb").read() == old
    port_bytes = open(caches["port"], "rb").read()
    j_at.autotune_ec(3, 8, variant="ref", nnz=256, tiles=(8,),
                     block_ps=(64,), repeats=1)
    assert open(caches["port"], "rb").read() == port_bytes
    assert "3m_r8_float32_cpu_cpu_ref" in json.load(open(caches["ref"]))
    monkeypatch.delenv(t_at.ENV_CACHE)
    monkeypatch.delenv(j_at.ENV_CACHE)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert t_at.cache_path() != j_at.cache_path()
    assert os.path.dirname(t_at.cache_path()) == \
        os.path.dirname(j_at.cache_path())


def test_empty_env_disables_the_file(caches, monkeypatch, tmp_path):
    monkeypatch.setenv(t_at.ENV_CACHE, "")
    t_at.autotune_ec(3, 8, variant="blocked", device="cpu", **TINY_GRID)
    assert t_at.cache_path() is None and not os.listdir(tmp_path)


@pytest.mark.parametrize("preset", ["fused", "sorted"])
@pytest.mark.parametrize("winner", [(16, 64, 3), (8, 128, 2)])
def test_presets_plan_bitwise_with_one_winner(preset, winner, small_tensor,
                                              monkeypatch):
    """Both tuners patched to one ECConfig: the unmodified preset plans the
    same arrays in both packages, and resolves the same ring depth."""
    calls = []

    def fake(mod):
        def tune(nmodes, rank, **kw):
            calls.append((mod.__name__, nmodes, rank, kw.get("variant")))
            return mod.ECConfig(*winner)
        return tune

    monkeypatch.setattr(j_at, "autotune_ec", fake(j_at))
    monkeypatch.setattr(t_at, "autotune_ec", fake(t_at))
    jcfg = japi.preset(preset, {"rank": 8, "runtime.num_devices": 1})
    tcfg = tapi.preset(preset, {"rank": 8, "runtime.num_devices": 1})
    jp = japi.plan(small_tensor, jcfg)
    tp = tapi.plan(SparseTensor(small_tensor.indices, small_tensor.values,
                                small_tensor.shape), tcfg, device="cpu")
    for jm, tm in zip(jp.modes, tp.modes, strict=True):
        assert (tm.tile, tm.block_p) == winner[:2] == (jm.tile, jm.block_p)
        for f in ("indices", "values", "local_rows", "block_to_tile",
                  "tile_visited", "nnz_true", "blocks_true"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    jkw = jcfg.kernel.mttkrp_kwargs(nmodes=3, rank=8)
    tkw = tcfg.kernel.mttkrp_kwargs(nmodes=3, rank=8, device="cpu")
    assert jkw == tkw and tkw["num_buffers"] == winner[2]
    assert {c[3] for c in calls} == {preset}


def test_explicit_geometry_beats_the_winner(small_tensor, monkeypatch):
    monkeypatch.setattr(t_at, "autotune_ec",
                        lambda *a, **k: t_at.ECConfig(16, 64, 3))
    cfg = tapi.preset("fused", {"rank": 8, "partition.tile": 8,
                                "kernel.num_buffers": 2})
    plan = tapi.plan(SparseTensor(small_tensor.indices, small_tensor.values,
                                  small_tensor.shape), cfg, device="cpu")
    assert (plan.modes[0].tile, plan.modes[0].block_p) == (8, 64)
    assert cfg.kernel.mttkrp_kwargs(nmodes=3, rank=8,
                                    device="cpu")["num_buffers"] == 2


@pytest.mark.parametrize("rows", [1, 7, 64, 1000])
def test_chunk_candidates_and_keys_match_reference(rows):
    for nc in ((1, 2, 4, 8), (3, 5)):
        assert t_xchg._candidates(rows, nc) == j_xchg._candidates(rows, nc)
    assert t_xchg._cache_key(rows, 8, 4, "bfloat16", "gpu") == \
        j_xchg._cache_key(rows, 8, 4, "bfloat16", "gpu")


def test_chunk_tuner_on_four_cpu_devices(caches):
    from repro_torch.comm import volume
    mesh = t_dm.cp_mesh(4, 2, devices=["cpu"] * 4)
    volume.reset_sent_bytes()
    volume.count_sent("gather", 0, 12)
    best = t_xchg.autotune_chunk_rows(64, 8, mesh, repeats=1)
    assert best in t_xchg._candidates(64, t_xchg.DEFAULT_NUM_CHUNK_CANDIDATES)
    # the tuning copies are not counted as a run's exchange traffic
    assert volume._SENT == {("gather", 0): 12}
    entry = json.load(open(caches["port"]))[
        "xchg_overlap_rows64_r8_m4_float32_cpu"]
    assert entry["chunk_rows"] == best
    assert set(entry["timings"]) == {"c64", "c32", "c16", "c8"}
    assert t_xchg.autotune_chunk_rows(64, 8, mesh, repeats=1) == best
    one = t_dm.cp_mesh(1, 1, devices=["cpu"])
    # identity: the default chunking, untimed
    assert t_xchg.autotune_chunk_rows(64, 8, one) == \
        comm.default_chunk_rows(64)
    volume.reset_sent_bytes()
