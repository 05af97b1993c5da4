"""End-to-end dynamic rebalancing on 4 logical devices, the port against the
reference with the same injected probe times.

Measured EC times differ between the packages and from run to run, so
neither package times anything here: each package's module-level
``measure_mode_device_times`` is replaced by one function of the plan
(``fixed_times``: a constant plus a term per executed kernel slot and per
nonzero, so a member's time follows its blocks as migrations move them).
The reference runs in one subprocess with ``XLA_FLAGS`` forcing 4 host
devices (the main test process must not set it); nothing in ``repro``
changes. Both run ``api.compile(plan, cfg).run(5)`` with
``schedule.rebalance="on"``, ``cadence=1``, on two tensors:

* the hot-index tensor of tests/test_schedule_multidevice.py at a quarter
  of its size (``equal_nnz``: one group of 4, the scattered members
  execute ~18x the hot member's blocks);
* a zipf tensor at ``amped_cdf``, r = 2 (two groups of 2, every mode
  migrates).

With the ``ref`` EC: identical ``schedule_events``, every array of the
final plan bitwise equal, and fits within 1e-4 (the two packages' eigh and
matmul round differently in the last bits; the migrations regroup the
merge's sums the same way in both). With the ``sorted`` preset the port is
held against its own ``ref`` run on the same layout: the same events and
plan, fits within 1e-4 (``sorted`` regroups long runs' sums).
"""
import ast
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.core.coo import SparseTensor, random_sparse  # noqa: E402
from repro_torch.core.partition import ModePartition  # noqa: E402
from repro_torch.schedule import rebalance as t_reb  # noqa: E402

ITERS = 5
FIELDS = [f for f in ModePartition.__dataclass_fields__]


def tensors(SparseTensor, random_sparse):
    rng = np.random.default_rng(0)
    nnz, n0, n12 = 20000, 16384, 128
    hot = nnz * 3 // 10
    i0 = np.concatenate([rng.integers(0, 3, hot),
                         rng.integers(3, n0, nnz - hot)])
    return {
        "hot": SparseTensor(
            np.stack([i0, rng.integers(0, n12, nnz),
                      rng.integers(0, n12, nnz)], 1).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32),
            (n0, n12, n12)).deduplicated(),
        "zipf": random_sparse((2000, 300, 200), 20000, seed=3,
                              distribution="zipf"),
    }


def fixed_times(part):
    return (1e-5 + 1e-8 * part.blocks_true.astype(np.float64) * part.block_p
            + 1e-10 * part.nnz_true.astype(np.float64))


def overrides(name, extra=None):
    policy = ({"partition.strategy": "equal_nnz"} if name == "hot"
              else {"partition.replication": 2})
    return {"rank": 8, "runtime.tol": 0.0, "runtime.num_devices": 4,
            "schedule.rebalance": "on", "schedule.cadence": 1,
            "schedule.imbalance_threshold": 1.1,
            "schedule.migration_budget": 0.4, **policy, **(extra or {})}


SCRIPT = r"""
import sys
import numpy as np, jax
import repro.api as api
from repro.core.coo import SparseTensor, random_sparse
from repro.schedule import rebalance

assert jax.device_count() == 4, jax.device_count()
ITERS, FIELDS = {consts}
{helpers}

def injected(part, factors, kernel_kw=None, *, repeats=1, jit_cache=None):
    return fixed_times(part)

rebalance.measure_mode_device_times = injected
out, events = {{}}, {{}}
for name, t in tensors(SparseTensor, random_sparse).items():
    cfg = api.paper(overrides(name))
    with api.compile(api.plan(t, cfg), cfg) as solver:
        res = solver.run(ITERS)
        out[f"{{name}}_fits"] = np.asarray(res.fits)
        out[f"{{name}}_epoch"] = np.asarray(solver.plan.rebalance_epoch)
        for w, part in enumerate(solver.plan.modes):
            for f in FIELDS:
                out[f"{{name}}_{{w}}_{{f}}"] = np.asarray(getattr(part, f))
        events[name] = solver.schedule_events
np.savez(sys.argv[1], **out)
with open(sys.argv[2], "w") as fh:
    fh.write(repr(events))
print("done")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    helpers = "\n".join(inspect.getsource(f)
                        for f in (tensors, fixed_times, overrides))
    src = SCRIPT.format(consts=repr((ITERS, FIELDS)), helpers=helpers)
    d = tmp_path_factory.mktemp("jax_rebalance")
    npz, ev = d / "out.npz", d / "events.txt"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, "-c", src, str(npz), str(ev)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(npz)), ast.literal_eval(ev.read_text())


@pytest.fixture
def injected_times(monkeypatch):
    monkeypatch.setattr(
        t_reb, "measure_mode_device_times",
        lambda part, factors, kernel_kw=None, *, arrays, repeats=1:
        fixed_times(part))


def _run_port(name, extra=None):
    t = tensors(SparseTensor, random_sparse)[name]
    cfg = tapi.paper(overrides(name, extra))
    solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
    return solver, solver.run(ITERS)


def _assert_replicas_equal(solver):
    s = solver.state
    for reps in s.factors + s.grams + [s.lam, s.replica_fits]:
        for x in reps[1:]:
            assert torch.equal(reps[0], x)


def _assert_same_plan(a, b):
    assert a.rebalance_epoch == b.rebalance_epoch
    for pa, pb in zip(a.modes, b.modes, strict=True):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f),
                                          err_msg=f"mode {pa.mode} {f}")


@pytest.mark.parametrize("name", ["hot", "zipf"])
def test_rebalanced_run_matches_reference(jax_out, injected_times, name):
    arrays, events = jax_out
    solver, res = _run_port(name)
    assert solver.schedule_events == events[name]
    assert int(arrays[f"{name}_epoch"]) == solver.plan.rebalance_epoch >= 1
    assert sum(e["moved_nnz"] for e in solver.schedule_events) > 0
    for w, part in enumerate(solver.plan.modes):
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(part, f)), arrays[f"{name}_{w}_{f}"],
                err_msg=f"mode {w} {f}")
    np.testing.assert_allclose(res.fits, arrays[f"{name}_fits"], atol=1e-4)
    _assert_replicas_equal(solver)


@pytest.mark.parametrize("name", ["hot", "zipf"])
def test_sorted_rebalanced_run_matches_its_ref_run(injected_times, name):
    layout = {"partition.layout": "sorted"}
    s_ref, r_ref = _run_port(name, layout)
    s_srt, r_srt = _run_port(name, {**layout, "kernel.variant": "sorted",
                                    "kernel.use_kernel": True})
    assert s_srt._kernel_kw["variant"] == "sorted"
    assert s_srt.schedule_events == s_ref.schedule_events
    assert s_srt.plan.rebalance_epoch >= 1
    _assert_same_plan(s_srt.plan, s_ref.plan)
    np.testing.assert_allclose(r_srt.fits, r_ref.fits, atol=1e-4)
    _assert_replicas_equal(s_srt)
    # the placed shards are the migrated plan's, descriptors recomputed
    from repro_torch.core.partition import block_segment_descriptors
    for mode, part in enumerate(s_srt.plan.modes):
        for k, dev in enumerate(s_srt.dev_arrays[mode]):
            np.testing.assert_array_equal(dev.indices.numpy(),
                                          part.indices[k])
            ss, sr = block_segment_descriptors(
                part.local_rows[k], tile=part.tile, block_p=part.block_p)
            np.testing.assert_array_equal(dev.seg_starts.numpy(), ss)
            np.testing.assert_array_equal(dev.seg_rows.numpy(), sr)
