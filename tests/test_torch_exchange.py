"""The port's exchange collectives (repro_torch.comm) on 4 logical CPU
devices, against the reference's repro.comm on 4 JAX CPU devices.

One subprocess (module-scoped; ``XLA_FLAGS`` forces 4 host devices, which
the main test process must not set) runs the reference's collectives
inside ``shard_map`` on (2, 2), (4, 1) and (1, 4) meshes over inputs this
module writes, and returns every device's result. The port runs the same
inputs on ``cp_mesh(4, r, devices=["cpu"] * 4)``.

Tolerances: the gathers are pure data movement, and both packages round
to bf16 to nearest even, so every gather is held bitwise, fp32 and bf16
wire. ``ring_rs`` takes the reference's hop order: bitwise. The port's
``psum_scatter`` sums in member order: bitwise at r = 2 (a two-term sum
has one result), to 1e-6 relative at r = 4, where XLA's order is its own.
The in-process cases (resolution precedence, spec validation, the volume
model) are those of tests/test_exchange.py, run against the port.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import comm as jcomm  # noqa: E402
from repro.core.partition import build_plan as j_build_plan  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.api import ExchangeConfig  # noqa: E402
from repro_torch.comm import collectives  # noqa: E402
from repro_torch.core import exchange as core_exchange  # noqa: E402
from repro_torch.core.coo import SparseTensor  # noqa: E402
from repro_torch.core.mttkrp import cp_mesh  # noqa: E402
from repro_torch.core.partition import build_plan as t_build_plan  # noqa: E402

MESHES = {"g2s2": (2, 2), "g4s1": (4, 1), "g1s4": (1, 4)}
# 24 rows over 4 devices: chunks of 2 and 6 rows divide a device's 6, one of
# 4 leaves an uneven tail of 2
GATHERS = {"allgather": ("allgather", {}), "ring": ("ring", {}),
           "overlap2": ("overlap", {"chunk_rows": 2}),
           "overlap4": ("overlap", {"chunk_rows": 4}),
           "overlap6": ("overlap", {"chunk_rows": 6})}
MERGES = {"psum_scatter": ("psum_scatter", None),
          "ring_rs": ("ring_rs", None), "ring_rs_bf16": ("ring_rs", "bf16")}

SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro import comm

assert jax.device_count() == 4, jax.device_count()
inp = np.load(sys.argv[1])
MESHES = {"g2s2": (2, 2), "g4s1": (4, 1), "g1s4": (1, 4)}
GATHERS = {"allgather": ("allgather", {}), "ring": ("ring", {}),
           "overlap2": ("overlap", {"chunk_rows": 2}),
           "overlap4": ("overlap", {"chunk_rows": 4}),
           "overlap6": ("overlap", {"chunk_rows": 6})}
MERGES = {"psum_scatter": ("psum_scatter", None),
          "ring_rs": ("ring_rs", None), "ring_rs_bf16": ("ring_rs", "bf16")}
WIRES = {"f32": None, "bf16": jnp.bfloat16}
axes = ("group", "sub")
out = {}


def per_device(mesh, fn, v):
    # device k (linear g*r+s) gets v[k]; its result comes back as row k
    f = lambda b: fn(b[0])[None]
    return np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=P(axes), out_specs=P(axes)))(jnp.asarray(v)))


for mname, shape in MESHES.items():
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), axes)
    for wname, wire in WIRES.items():
        for gname, (variant, kw) in GATHERS.items():
            out[f"gather_{mname}_{wname}_{gname}"] = per_device(
                mesh, lambda b: comm.all_gather_axes(
                    b, axes, variant=variant, wire_dtype=wire, **kw),
                inp["x"])
    if shape[1] > 1:
        for gname, (merge, wname) in MERGES.items():
            out[f"merge_{mname}_{gname}"] = per_device(
                mesh, lambda b: comm.merge_partials(
                    b, "sub", merge=merge, wire_dtype=WIRES[wname or "f32"]),
                inp["y"])
np.savez(sys.argv[2], **out)
print("done")
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(4, 6, 5)).astype(np.float32),
            "y": rng.normal(size=(4, 8, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_exchange")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _mesh(name):
    _, r = MESHES[name]
    return cp_mesh(4, r, devices=["cpu"] * 4)


def _port(fn, v):
    return np.stack([o.numpy() for o in fn([torch.from_numpy(b.copy())
                                            for b in v])])


@pytest.mark.parametrize("gname", list(GATHERS))
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_gather_bitwise_against_jax(jax_out, inputs, mname, wire, gname):
    """Every device's gathered block, every variant and wire: the same bits
    as the reference, and so the same on every replica."""
    mesh = _mesh(mname)
    variant, kw = GATHERS[gname]
    got = _port(lambda xs: comm.all_gather_axes(
        xs, mesh, ("group", "sub"), variant=variant,
        wire_dtype=torch.bfloat16 if wire == "bf16" else None, **kw),
        inputs["x"])
    want = jax_out[f"gather_{mname}_{wire}_{gname}"]
    assert got.shape == want.shape == (4, 24, 5)
    np.testing.assert_array_equal(got, want)
    if wire == "f32":
        np.testing.assert_array_equal(got[0], inputs["x"].reshape(24, 5))


@pytest.mark.parametrize("gname", list(MERGES))
@pytest.mark.parametrize("mname", ["g2s2", "g1s4"])
def test_merge_against_jax(jax_out, inputs, mname, gname):
    mesh = _mesh(mname)
    merge, wire = MERGES[gname]
    got = _port(lambda ps: comm.merge_partials(
        ps, mesh, "sub", merge=merge,
        wire_dtype=torch.bfloat16 if wire else None), inputs["y"])
    want = jax_out[f"merge_{mname}_{gname}"]
    assert got.shape == want.shape
    if merge == "psum_scatter" and mesh.r == 4:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_psum_scatter_sums_in_member_order(inputs):
    """The port's stated order: ((p_0 + p_1) + p_2) + p_3 for each block."""
    mesh = cp_mesh(4, 4, devices=["cpu"] * 4)
    y = inputs["y"]
    got = _port(lambda ps: comm.merge_partials(ps, mesh, "sub",
                                               merge="psum_scatter"), y)
    for s in range(4):
        blk = [torch.from_numpy(y[t, 2 * s:2 * s + 2]) for t in range(4)]
        want = ((blk[0] + blk[1]) + blk[2]) + blk[3]
        np.testing.assert_array_equal(got[s], want.numpy())


@pytest.mark.parametrize("fn", ["merge_partials", "ring_reduce_scatter"])
def test_nondivisible_merge_raises(fn):
    mesh = cp_mesh(4, 2, devices=["cpu"] * 4)
    xs = [torch.zeros(7, 3) for _ in range(4)]
    with pytest.raises(ValueError, match="not divisible"):
        getattr(comm, fn)(xs, mesh, "sub")


@pytest.mark.parametrize("variant", ["allgather", "ring", "overlap"])
def test_one_device_axis_is_the_identity(variant):
    """m == 1 / r == 1: the same tensors back, no cast, nothing sent."""
    mesh = cp_mesh(1, 1, devices=["cpu"])
    xs = [torch.ones(4, 3)]
    comm.reset_sent_bytes()
    out = comm.all_gather_axes(xs, mesh, ("group", "sub"), variant=variant,
                               wire_dtype=torch.bfloat16)
    assert out[0] is xs[0]
    assert comm.merge_partials(xs, mesh, "sub",
                               wire_dtype=torch.bfloat16)[0] is xs[0]
    assert comm.sent_bytes(1)[0]["total_bytes"] == 0


def test_axis_groups_follow_the_reference_numbering():
    mesh = cp_mesh(4, 2, devices=["cpu"] * 4)
    assert mesh.axis_groups(("group", "sub")) == [[0, 1, 2, 3]]
    assert mesh.axis_groups("sub") == [[0, 1], [2, 3]]
    assert mesh.axis_groups("group") == [[0, 2], [1, 3]]
    assert comm.axis_size(mesh, "sub") == 2
    assert comm.axis_size(mesh, ("group", "sub")) == 4


# --- in-process: resolution, validation, volume model ----------------------
# (tests/test_exchange.py's cases, run against the port)

def test_variant_resolution_precedence(monkeypatch):
    monkeypatch.delenv(comm.ENV_VARIANT, raising=False)
    assert comm.resolve_variant(None, True) == "ring"
    assert comm.resolve_variant(None, False) == "allgather"
    assert comm.resolve_variant(None, None) == comm.DEFAULT_VARIANT
    monkeypatch.setenv(comm.ENV_VARIANT, "overlap")
    assert comm.resolve_variant(None, True) == "overlap"
    assert comm.resolve_variant("ring", True) == "ring"
    with pytest.raises(ValueError, match="unknown exchange variant"):
        comm.resolve_variant("nope")


def test_merge_resolution(monkeypatch):
    monkeypatch.delenv(comm.ENV_MERGE, raising=False)
    assert comm.resolve_merge(None) == "psum_scatter"
    monkeypatch.setenv(comm.ENV_MERGE, "ring_rs")
    assert comm.resolve_merge(None) == "ring_rs"
    with pytest.raises(ValueError, match="unknown exchange merge"):
        comm.resolve_merge("nope")


def test_exchange_config_validation(monkeypatch):
    monkeypatch.delenv(comm.ENV_VARIANT, raising=False)
    for cfg, variant in ((ExchangeConfig(), "ring"),
                         (ExchangeConfig(ring=False), "allgather"),
                         (ExchangeConfig(variant="overlap"), "overlap")):
        assert comm.resolve_exchange_spec(cfg).variant == variant
    with pytest.raises(ValueError, match="exchange.variant"):
        ExchangeConfig(variant="bogus")
    with pytest.raises(ValueError, match="exchange.merge"):
        ExchangeConfig(merge="bogus")
    with pytest.raises(ValueError, match="wire_dtype"):
        ExchangeConfig(wire_dtype="float16")
    with pytest.raises(ValueError, match="chunk_rows"):
        ExchangeConfig(chunk_rows=0)


def test_exchange_spec_resolution(monkeypatch):
    monkeypatch.delenv(comm.ENV_VARIANT, raising=False)
    monkeypatch.delenv(comm.ENV_MERGE, raising=False)
    spec = comm.resolve_exchange_spec(ExchangeConfig(
        variant="overlap", merge="ring_rs", chunk_rows=16,
        wire_dtype="bfloat16"))
    assert (spec.variant, spec.merge, spec.chunk_rows) == \
        ("overlap", "ring_rs", 16)
    assert spec.wire_dtype == "bfloat16" and spec.wire is torch.bfloat16
    assert comm.resolve_exchange_spec(ExchangeConfig()).wire is None
    # no config: the environment, then the defaults
    assert comm.resolve_exchange_spec(None) == comm.ExchangeSpec()
    monkeypatch.setenv(comm.ENV_VARIANT, "allgather")
    monkeypatch.setenv(comm.ENV_MERGE, "ring_rs")
    assert comm.resolve_exchange_spec(None) == comm.ExchangeSpec(
        variant="allgather", merge="ring_rs")
    monkeypatch.delenv(comm.ENV_VARIANT)
    monkeypatch.delenv(comm.ENV_MERGE)
    with pytest.raises(ValueError):
        comm.ExchangeSpec(variant="bogus")
    # the same resolution as the reference, field by field
    for cfg in (dict(), dict(ring=False), dict(variant="overlap"),
                dict(wire_dtype="bfloat16"), dict(merge="ring_rs")):
        j = jcomm.resolve_exchange_spec(jcomm_config(cfg))
        t = comm.resolve_exchange_spec(ExchangeConfig(**cfg))
        assert (t.variant, t.merge, t.chunk_rows, t.wire_dtype) == \
            (j.variant, j.merge, j.chunk_rows, j.wire_dtype)


def jcomm_config(fields):
    from repro.api import ExchangeConfig as JExchangeConfig
    return JExchangeConfig(**fields)


def test_bf16_wire_merge_normalization(monkeypatch):
    monkeypatch.delenv(comm.ENV_MERGE, raising=False)
    spec = comm.resolve_exchange_spec(ExchangeConfig(wire_dtype="bfloat16"))
    assert spec.merge == "ring_rs"
    with pytest.raises(ValueError, match="psum_scatter"):
        comm.resolve_exchange_spec(ExchangeConfig(
            wire_dtype="bfloat16", merge="psum_scatter"))
    monkeypatch.setenv(comm.ENV_MERGE, "psum_scatter")
    with pytest.raises(ValueError, match="psum_scatter"):
        comm.resolve_exchange_spec(ExchangeConfig(wire_dtype="bfloat16"))
    with pytest.raises(ValueError, match="psum_scatter"):
        comm.ExchangeSpec(wire_dtype="bfloat16", merge="psum_scatter")


def test_overlap_chunk_autotune_raises_not_falls_back(monkeypatch):
    monkeypatch.delenv(comm.ENV_VARIANT, raising=False)
    with pytest.raises(NotImplementedError, match="Autotuner"):
        comm.resolve_exchange_spec(ExchangeConfig(variant="overlap",
                                                  autotune_chunk=True))
    # an explicit chunk, or another variant, needs no autotuner
    assert comm.resolve_exchange_spec(ExchangeConfig(
        variant="overlap", autotune_chunk=True, chunk_rows=8)).chunk_rows == 8
    assert comm.resolve_exchange_spec(ExchangeConfig(
        variant="ring", autotune_chunk=True)).variant == "ring"


def test_core_exchange_shim_keeps_historical_default(monkeypatch):
    sig = inspect.signature(core_exchange.all_gather_axes)
    assert sig.parameters["ring"].default is False
    monkeypatch.setenv(comm.ENV_VARIANT, "ring")

    def no_ring(*a, **k):
        raise AssertionError("the shim's default must not take the ring")

    monkeypatch.setattr(collectives, "ring_all_gather", no_ring)
    mesh = cp_mesh(4, 2, devices=["cpu"] * 4)
    xs = [torch.full((2, 3), float(k)) for k in range(4)]
    out = core_exchange.all_gather_axes(xs, mesh, ("group", "sub"))
    for o in out:
        np.testing.assert_array_equal(o.numpy(), torch.cat(xs).numpy())


def test_volume_model_matches_reference(small_tensor):
    """The same model as the reference on the same plan; a bf16 wire
    halves it; one device sends nothing."""
    t = small_tensor
    rank = 8
    tt = SparseTensor(t.indices, t.values, t.shape)
    assert comm.modelled_exchange_bytes(
        t_build_plan(tt, 1), rank)["sweep_total_bytes"] == 0
    for m, r in ((4, 2), (4, 1), (4, 4)):
        jplan = j_build_plan(t, m, replication=r)
        tplan = t_build_plan(tt, m, replication=r)
        for wire in (None, "bfloat16"):
            assert comm.modelled_exchange_bytes(tplan, rank,
                                                wire_dtype=wire) == \
                jcomm.modelled_exchange_bytes(jplan, rank, wire_dtype=wire)
        full = comm.modelled_exchange_bytes(tplan, rank)
        half = comm.modelled_exchange_bytes(tplan, rank,
                                            wire_dtype="bfloat16")
        assert half["sweep_total_bytes"] * 2 == full["sweep_total_bytes"]


def test_default_chunk_rows():
    assert comm.default_chunk_rows(24) == 12
    assert comm.default_chunk_rows(1) == 1
    assert comm.default_chunk_rows(3) == 2


@pytest.mark.parametrize("exchange", [
    {"exchange.variant": "allgather"}, {"exchange.variant": "ring"},
    {"exchange.variant": "overlap", "exchange.chunk_rows": 4},
    {"exchange.variant": "overlap", "exchange.wire_dtype": "bfloat16"}])
def test_counted_bytes_equal_modelled(small_tensor, exchange):
    """What the collectives copy between logical devices, per mode and
    sweep, is what the model says — for every gather variant, fp32 and
    bf16 wire."""
    t = SparseTensor(small_tensor.indices, small_tensor.values,
                     small_tensor.shape)
    cfg = tapi.preset("paper", {"rank": 8, "runtime.num_devices": 4,
                                "partition.replication": 2, **exchange})
    solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
    rep = solver.exchange_report()
    want = rep["modelled"]["sweep_total_bytes"]
    assert want > 0
    # every logical device, not only the one that sent the most
    assert rep["counted"]["sweep_bytes_per_device"] == [want] * 4
    for c, m in zip(rep["counted"]["per_mode"], rep["modelled"]["per_mode"]):
        assert c == [m] * 4
    # a sweep counts the same bytes as the report's extra pass
    comm.reset_sent_bytes()
    solver.sweep()
    assert [s["total_bytes"] for s in comm.sent_bytes(4)] == [want] * 4


def test_sent_bytes_sees_a_device_that_sends_less():
    """A schedule fault that leaves one device short shows in its count,
    and a count outside the mesh raises."""
    from repro_torch.comm import volume
    comm.reset_sent_bytes()
    for d in range(4):
        volume.count_sent("gather", d, 96 if d != 2 else 64)
    volume.count_sent("merge", 1, 32)
    got = comm.sent_bytes(4)
    assert [s["gather_bytes"] for s in got] == [96, 96, 64, 96]
    assert [s["total_bytes"] for s in got] == [96, 128, 64, 96]
    with pytest.raises(ValueError, match="outside a mesh of 2"):
        comm.sent_bytes(2)
    comm.reset_sent_bytes()
