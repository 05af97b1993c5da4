"""The port's copies of the host-side planner against the reference's,
bitwise: COO container and generators, dataset profiles and .tns reading,
static policies, and build_plan (every array of every mode) with its
segment descriptors."""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401  (the reference's tests run with jax on CPU)

from repro.core import coo as j_coo  # noqa: E402
from repro.core import partition as j_part  # noqa: E402
from repro.schedule import static as j_static  # noqa: E402
from repro.sparse import io as j_io  # noqa: E402
from repro_torch.core import coo as t_coo  # noqa: E402
from repro_torch.core import partition as t_part  # noqa: E402
from repro_torch.schedule import static as t_static  # noqa: E402
from repro_torch.sparse import io as t_io  # noqa: E402


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _assert_same_tensor(a, b):
    _assert_same(a.indices, b.indices, "indices")
    _assert_same(a.values, b.values, "values")
    assert a.shape == b.shape


def _assert_same_plan(jp, tp):
    assert jp.shape == tp.shape and jp.num_devices == tp.num_devices
    assert jp.norm == tp.norm
    for d, (jm, tm) in enumerate(zip(jp.modes, tp.modes, strict=True)):
        for f in dataclasses.fields(tm):
            _assert_same(getattr(jm, f.name), getattr(tm, f.name),
                         f"mode {d} {f.name}")
        js = j_part.block_segment_descriptors(jm.local_rows, tile=jm.tile,
                                              block_p=jm.block_p)
        ts = t_part.block_segment_descriptors(tm.local_rows, tile=tm.tile,
                                              block_p=tm.block_p)
        for a, b, name in zip(js, ts, ("seg_starts", "seg_rows")):
            _assert_same(a, b, f"mode {d} {name}")
    for name in ("global_to_padded", "padded_to_global"):
        for d, (a, b) in enumerate(zip(getattr(jp, name), getattr(tp, name))):
            _assert_same(a, b, f"{name}[{d}]")


@pytest.mark.parametrize("nmodes", [3, 4, 5])
@pytest.mark.parametrize("layout", ["blocked", "sorted"])
@pytest.mark.parametrize("num_devices,strategy,replication", [
    (1, "amped_cdf", 1), (2, "amped_cdf", None), (4, "amped_lpt", 2),
    (2, "equal_nnz", None), (2, "uniform_index", 1)])
def test_build_plan_bitwise(nmodes, layout, num_devices, strategy,
                            replication):
    shape = (40, 30, 20, 12, 9)[:nmodes]
    jt = j_coo.random_sparse(shape, 700, seed=nmodes, distribution="zipf")
    tt = t_coo.random_sparse(shape, 700, seed=nmodes, distribution="zipf")
    _assert_same_tensor(jt, tt)
    kw = dict(strategy=strategy, replication=replication, tile=8,
              block_p=32, layout=layout)
    _assert_same_plan(j_part.build_plan(jt, num_devices, **kw),
                      t_part.build_plan(tt, num_devices, **kw))


@pytest.mark.parametrize("name,scale", [("amazon", 1e-5), ("patents", 3e-6),
                                        ("reddit", 2e-6), ("twitch", 2e-5)])
def test_profile_tensor_and_plan_bitwise(name, scale):
    assert j_io.profile_geometry(name, scale) == \
        t_io.profile_geometry(name, scale)
    jt = j_io.make_profile_tensor(name, scale=scale, seed=3)
    tt = t_io.make_profile_tensor(name, scale=scale, seed=3)
    _assert_same_tensor(jt, tt)
    _assert_same_plan(j_part.build_plan(jt, 1, layout="sorted"),
                      t_part.build_plan(tt, 1, layout="sorted"))


@pytest.mark.parametrize("b2t,ok", [
    ([0, 0, 1, 1, 1], True),      # trailing pads revisit the last used tile
    ([2, 0, 0, 5], True),         # runs need not be in tile order
    ([], True),                   # empty shard
    ([0, 0, 1, 0], False),        # tile 0 visited again after tile 1
    ([3, 1, 3, 3], False),
])
def test_validate_plan_tile_runs(b2t, ok):
    """Every tile a device visits is one run of consecutive blocks: the EC
    kernels write each run's tile once, without atomics."""
    tt = t_coo.random_sparse((40, 30, 20), 700, seed=3, distribution="zipf")
    plan = t_part.build_plan(tt, 1, tile=8, block_p=32, layout="sorted")
    part = dataclasses.replace(
        plan.modes[0], block_to_tile=np.asarray([b2t], np.int32))
    edited = dataclasses.replace(plan, modes=(part,) + plan.modes[1:])
    if ok:
        assert t_part.validate_plan(edited) is edited
    else:
        with pytest.raises(ValueError, match="more than one run"):
            t_part.validate_plan(edited)


def test_coo_helpers_bitwise():
    dense = np.random.default_rng(0).normal(size=(6, 5, 4)).astype(np.float32)
    dense[np.abs(dense) < 0.5] = 0
    jt, tt = j_coo.from_dense(dense), t_coo.from_dense(dense)
    _assert_same_tensor(jt, tt)
    _assert_same(j_coo.to_dense(jt), t_coo.to_dense(tt), "to_dense")
    for dist in ("uniform", "zipf"):
        a = j_coo.draw_sparse_block(np.random.default_rng(1), (9, 7, 5), 50,
                                    distribution=dist)
        b = t_coo.draw_sparse_block(np.random.default_rng(1), (9, 7, 5), 50,
                                    distribution=dist)
        for x, y in zip(a, b):
            _assert_same(x, y, dist)
    dup = j_coo.random_sparse((4, 4, 4), 200, seed=2, dedup=False)
    _assert_same_tensor(dup.deduplicated(), t_coo.SparseTensor(
        dup.indices, dup.values, dup.shape).deduplicated())


def test_read_tns_bitwise(tmp_path):
    t = j_coo.random_sparse((30, 20, 10), 300, seed=4)
    for name in ("x.tns", "x.tns.gz"):
        path = str(tmp_path / name)
        j_io.write_tns(path, t)
        _assert_same_tensor(j_io.read_tns(path, chunk_lines=64),
                            t_io.read_tns(path, chunk_lines=64))


def test_static_policies_bitwise():
    rng = np.random.default_rng(5)
    for hist in (rng.zipf(1.3, size=200) - 1, np.zeros(7, np.int64),
                 rng.integers(0, 50, size=33)):
        hist = np.asarray(hist, np.int64)
        for m in (1, 2, 4, 8):
            assert j_static.auto_replication(hist, m) == \
                t_static.auto_replication(hist, m)
        for name in j_static.POLICY_NAMES:
            for groups in (1, 3, 4):
                _assert_same(j_static.get_policy(name).assign(hist, groups),
                             t_static.get_policy(name).assign(hist, groups),
                             f"{name}/{groups}")
    assert j_static.POLICY_NAMES == t_static.POLICY_NAMES
