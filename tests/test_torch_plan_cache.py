"""The port's plan cache and plan serialization on the CPU.

Twins of tests/test_plan_serialization.py (bit-exact round trip, stale
signatures and foreign format versions refused, no reuse across tensors or
strategies, a corrupt entry rebuilt), plus what makes one cache directory
serve both packages: ``plan_signature`` gives the reference's hex string
for the same tensor (in memory or a tensor store), config and device
count; a plan saved by either package loads in the other with every array
bitwise equal, lazy store plans included (their load reads no chunk); and
``plan(cache_dir=)`` hits an entry the reference wrote, and the other way
round. Cache hits and misses are counted in ``CACHE_STATS`` and the
``plan.cache_*`` counters of the process registry.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.api as japi  # noqa: E402
from repro.core.partition import build_plan as j_build_plan  # noqa: E402
from repro.store import TensorStore as JTensorStore  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
from repro_torch.core.partition import ModePartition, build_plan  # noqa: E402
from repro_torch.store import TensorStore, write_store_from_coo  # noqa: E402


@pytest.fixture(scope="module")
def plan3():
    t = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    return build_plan(t, 1)


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    t = random_sparse((60, 40, 30), 2000, seed=3)
    path = str(tmp_path_factory.mktemp("st") / "t.store")
    write_store_from_coo(t, path, chunk_nnz=256)
    return path


def _port_tensor(t):
    return SparseTensor(t.indices, t.values, t.shape)


def _assert_plans_equal(a, b):
    """Every scalar and array of two plans (of either package) equal,
    dtypes included; lazy partitions by their layouts."""
    assert tuple(a.shape) == tuple(b.shape)
    assert a.num_devices == b.num_devices
    assert a.norm == b.norm
    assert a.rebalance_epoch == b.rebalance_epoch
    for d in range(len(a.shape)):
        pa, pb = a.modes[d], b.modes[d]
        assert bool(getattr(pa, "lazy", False)) == \
            bool(getattr(pb, "lazy", False))
        for k in ModePartition.META_FIELDS:
            assert getattr(pa, k) == getattr(pb, k), k
        if getattr(pa, "lazy", False):
            np.testing.assert_array_equal(pa.rows_owned, pb.rows_owned)
            assert pa.store.digest == pb.store.digest
        else:
            for k in ModePartition.ARRAY_FIELDS:
                x, y = getattr(pa, k), getattr(pb, k)
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert a.global_to_padded[d].dtype == b.global_to_padded[d].dtype
        assert a.padded_to_global[d].dtype == b.padded_to_global[d].dtype
        np.testing.assert_array_equal(a.global_to_padded[d],
                                      b.global_to_padded[d])
        np.testing.assert_array_equal(a.padded_to_global[d],
                                      b.padded_to_global[d])


# -- twins of tests/test_plan_serialization.py --------------------------------

def test_roundtrip_bit_exact(plan3, tmp_path):
    path = api.save_plan(plan3, str(tmp_path / "p"), signature="sig0")
    _assert_plans_equal(api.load_plan(path), plan3)


def test_stale_signature_rejected(plan3, tmp_path):
    path = api.save_plan(plan3, str(tmp_path / "p"), signature="sig0")
    api.load_plan(path, expect_signature="sig0")  # matching: fine
    with pytest.raises(api.PlanSignatureError, match="different problem"):
        api.load_plan(path, expect_signature="sig-other")


def test_format_version_rejected(plan3, tmp_path):
    path = api.save_plan(plan3, str(tmp_path / "p"))
    mpath = os.path.join(path, "manifest.json")
    man = json.load(open(mpath))
    man["format_version"] = 99
    json.dump(man, open(mpath, "w"))
    with pytest.raises(api.PlanSignatureError, match="format"):
        api.load_plan(path)


def test_cache_never_reuses_across_tensors(tmp_path):
    cfg = api.preset("paper", {"runtime.num_devices": 1})
    t1 = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    t2 = random_sparse((40, 30, 20), 700, seed=7, distribution="zipf")
    api.reset_cache_stats()
    api.plan(t1, cfg, cache_dir=str(tmp_path))
    api.plan(t2, cfg, cache_dir=str(tmp_path))            # different nnz
    api.plan(t1, cfg.with_overrides({"partition.strategy": "uniform_index"}),
             cache_dir=str(tmp_path))                     # different strategy
    assert api.CACHE_STATS == {"hits": 0, "misses": 3}
    p2 = api.plan(t2, cfg, cache_dir=str(tmp_path))       # t2 again: a hit
    assert api.CACHE_STATS["hits"] == 1
    assert p2.modes[0].nnz_true.sum() == t2.nnz


def test_corrupted_cache_entry_rebuilds(tmp_path):
    t = random_sparse((30, 20, 10), 300, seed=1)
    cfg = api.preset("paper", {"runtime.num_devices": 1})
    api.plan(t, cfg, cache_dir=str(tmp_path))
    (entry,) = os.listdir(tmp_path)
    with open(os.path.join(tmp_path, entry, "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    api.reset_cache_stats()
    p = api.plan(t, cfg, cache_dir=str(tmp_path))         # rebuilds, no raise
    assert api.CACHE_STATS == {"hits": 0, "misses": 1}
    assert p.modes[0].nnz_true.sum() == t.nnz
    api.plan(t, cfg, cache_dir=str(tmp_path))
    assert api.CACHE_STATS["hits"] == 1


def test_cache_counts_into_the_registry(small_tensor, tmp_path):
    obs.reset()
    api.reset_cache_stats()
    t = _port_tensor(small_tensor)
    cfg = api.preset("paper", {"runtime.num_devices": 1})
    api.plan(t, cfg)                                       # no cache: a miss
    cached = api.plan(t, cfg, cache_dir=str(tmp_path))
    again = api.plan(t, cfg, cache_dir=str(tmp_path))
    _assert_plans_equal(again, cached)
    assert api.CACHE_STATS == {"hits": 1, "misses": 2}
    reg = obs.get_registry()
    assert reg.counter("plan.cache_hits") == 1
    assert reg.counter("plan.cache_misses") == 2
    obs.reset()


# -- the cache shared with the reference --------------------------------------

SIGNATURE_CONFIGS = {
    "paper": {"runtime.num_devices": 1},
    "four_devices": {"runtime.num_devices": 4},
    "equal_nnz": {"runtime.num_devices": 4,
                  "partition.strategy": "equal_nnz"},
    "replicated_sorted_tile8": {"runtime.num_devices": 4,
                                "partition.replication": 2,
                                "partition.layout": "sorted",
                                "partition.tile": 8,
                                "partition.block_p": 64},
    "schedule_policy": {"runtime.num_devices": 2,
                        "schedule.policy": "uniform_index"},
}


@pytest.mark.parametrize("over", SIGNATURE_CONFIGS.values(),
                         ids=SIGNATURE_CONFIGS.keys())
def test_plan_signature_equals_the_reference(small_tensor, over):
    t = _port_tensor(small_tensor)
    jsig = japi.plan_signature(small_tensor, japi.preset("paper", over))
    tsig = api.plan_signature(t, api.preset("paper", over))
    assert tsig == jsig and len(tsig) == 64
    assert api.plan_signature(t, api.preset("paper", over),
                              rebalance_epoch=1) == \
        japi.plan_signature(small_tensor, japi.preset("paper", over),
                            rebalance_epoch=1) != tsig


def test_plan_signature_keys_on_the_tuned_geometry(small_tensor,
                                                   monkeypatch):
    """With ``kernel.autotune`` the signature holds the tuner's winner, as
    in the reference (both tuners patched to one winner here)."""
    from repro.kernels import autotune as j_at
    from repro_torch.kernels import autotune as t_at
    monkeypatch.setattr(j_at, "autotune_ec",
                        lambda *a, **k: j_at.ECConfig(16, 64, 3))
    monkeypatch.setattr(t_at, "autotune_ec",
                        lambda *a, **k: t_at.ECConfig(16, 64, 3))
    over = {"runtime.num_devices": 1}
    jsig = japi.plan_signature(small_tensor, japi.preset("fused", over))
    tsig = api.plan_signature(_port_tensor(small_tensor),
                              api.preset("fused", over), device="cpu")
    assert tsig == jsig
    fixed = {**over, "kernel.autotune": False, "partition.tile": 16,
             "partition.block_p": 64}
    assert api.plan_signature(_port_tensor(small_tensor),
                              api.preset("fused", fixed)) == tsig


def test_plan_signature_of_a_store_equals_the_reference(store_path):
    cfg = {"runtime.num_devices": 2}
    tsig = api.plan_signature(TensorStore(store_path),
                              api.preset("paper", cfg))
    jsig = japi.plan_signature(JTensorStore(store_path),
                               japi.preset("paper", cfg))
    assert tsig == jsig


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("devices,layout", [(1, "blocked"), (4, "sorted")])
def test_saved_plans_cross_between_the_packages(small_tensor, tmp_path,
                                                direction, devices, layout):
    jplan = j_build_plan(small_tensor, devices, layout=layout)
    tplan = build_plan(_port_tensor(small_tensor), devices, layout=layout)
    path = str(tmp_path / "p")
    if direction == "reference_to_port":
        japi.save_plan(jplan, path, signature="s")
        back = api.load_plan(path, expect_signature="s")
    else:
        api.save_plan(tplan, path, signature="s")
        back = japi.load_plan(path, expect_signature="s")
    _assert_plans_equal(back, jplan)
    _assert_plans_equal(back, tplan)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_lazy_store_plans_cross_between_the_packages(store_path, tmp_path,
                                                     direction):
    """A lazy plan's manifest names its store; either package rebinds it
    without reading a chunk, and the rebound partitions materialize the
    same shards as a fresh plan of the store."""
    cfg = {"runtime.num_devices": 2, "partition.layout": "sorted"}
    jstore, tstore = JTensorStore(store_path), TensorStore(store_path)
    jplan = japi.plan(jstore, japi.preset("paper", cfg))
    tplan = api.plan(tstore, api.preset("paper", cfg), device="cpu")
    path = str(tmp_path / "p")
    if direction == "reference_to_port":
        japi.save_plan(jplan, path, signature="s")
        back = api.load_plan(path, expect_signature="s")
    else:
        api.save_plan(tplan, path, signature="s")
        back = japi.load_plan(path, expect_signature="s")
    assert back.modes[0].store.access_stats["chunk_reads"] == 0
    _assert_plans_equal(back, jplan)
    _assert_plans_equal(back, tplan)
    for d in range(len(tplan.shape)):
        want = tplan.modes[d].materialize()
        got = back.modes[d].materialize()
        for k in ModePartition.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)


def test_lazy_plan_refuses_a_rewritten_store(tmp_path):
    t = random_sparse((30, 20, 10), 300, seed=2)
    path = str(tmp_path / "s.store")
    write_store_from_coo(t, path, chunk_nnz=64)
    plan = api.plan(TensorStore(path), api.preset("paper"), device="cpu")
    saved = api.save_plan(plan, str(tmp_path / "p"))
    write_store_from_coo(random_sparse((30, 20, 10), 310, seed=2), path,
                         chunk_nnz=64)
    with pytest.raises(api.PlanSignatureError, match="digest"):
        api.load_plan(saved)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_cache_directory_serves_both_packages(small_tensor, store_path,
                                                  tmp_path, writer):
    """``plan(cache_dir=)`` in one package hits the entry the other wrote:
    for an in-memory tensor and for a store."""
    over = {"runtime.num_devices": 2}
    cache = str(tmp_path / "plans")
    jcfg, tcfg = japi.preset("paper", over), api.preset("paper", over)
    cases = [(small_tensor, _port_tensor(small_tensor)),
             (JTensorStore(store_path), TensorStore(store_path))]
    japi.reset_cache_stats()
    api.reset_cache_stats()
    for jt, tt in cases:
        if writer == "reference":
            first = japi.plan(jt, jcfg, cache_dir=cache)
            second = api.plan(tt, tcfg, cache_dir=cache, device="cpu")
        else:
            first = api.plan(tt, tcfg, cache_dir=cache, device="cpu")
            second = japi.plan(jt, jcfg, cache_dir=cache)
        _assert_plans_equal(second, first)
    assert len(os.listdir(cache)) == 2
    written, read = (japi, api) if writer == "reference" else (api, japi)
    assert written.CACHE_STATS == {"hits": 0, "misses": 2}
    assert read.CACHE_STATS == {"hits": 2, "misses": 0}
