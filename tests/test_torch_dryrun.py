"""The port's dry-run (``repro_torch.launch.{mesh,shapes,roofline,dryrun}``
and ``models.sharding``'s rules) against the reference's
(``repro.launch``, ``repro.models.sharding``).

The reference builds its cells on ``jax.eval_shape`` over an
``AbstractMesh`` of the production shapes (no devices needed), the port on
the ``meta`` device over ``launch.mesh``'s description meshes. The port's
parameter tree and decode cache hold one entry per layer; the reference's
stack each pattern position's layers over cycles (``groups[pi]``, leaves
``(cyc, ...)``; the encoder's over layers). :func:`ref_layout` maps the
port's per-layer leaves to that layout, as ``models.convert`` maps
weights: a leaf's shape gains the stacked count in front, its spec a
leading ``None`` (an empty spec, replicated, stays empty), and every
cycle's entry must agree. Dtypes are equal
(int32 tokens on both sides); the decode position is a Python int in the
port (its cache design) and an int32 scalar in the reference.

What is held exactly: ``param_count`` of the ten configs; every cell's
argument shapes and dtypes and ``kv_bytes``; ``param_specs`` /
``sanitize_specs`` and the batch and cache specs on both production meshes;
``zero1_specs`` where both sides have the same dimensions to shard (see
``test_zero1_specs`` for the cycle dimension); ``analytic_memory_bytes`` and
``roofline_terms`` under an equal ``HW``; the counted matrix FLOPs of the
reference's four smoke lowerings (``tests/test_dryrun_smoke.py``) against
its HLO ``dot_flops`` (tolerance 0: measured equal); the CP cell's shapes
and exchange bytes against the reference's committed record.
``active_param_count`` differs for jamba15_large only, by a fault of the
reference recorded in ``test_active_param_count``.
"""
import json
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.comm import volume as ref_volume  # noqa: E402
from repro.launch import roofline as ref_rf  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.models import sharding as ref_sharding  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline, shapes  # noqa: E402
from repro_torch.launch.mesh import (DescMesh, make_cp_production_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, c) for a in ARCH_IDS for c in shapes.SHAPE_CELLS
         if shapes.supports_cell(a, c)]


def meshes(name):
    dims, axes = MESHES[name]
    return AbstractMesh(dims, axes), DescMesh(dims, axes)


# ---------------------------------------------------------------------------
# layout mapping
# ---------------------------------------------------------------------------

def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def ref_flat(tree) -> dict:
    """{dotted path: leaf} of a reference pytree; a leaf is (shape, dtype)
    for an array struct, the spec tuple for a spec or sharding."""
    def is_leaf(x):
        return isinstance(x, (P, NamedSharding)) or x is None

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        name = ".".join(_key(k) for k in path)
        if isinstance(leaf, NamedSharding):
            leaf = tuple(leaf.spec)
        elif isinstance(leaf, P):
            leaf = tuple(leaf)
        elif hasattr(leaf, "shape"):
            leaf = (tuple(leaf.shape), str(leaf.dtype))
        out[name] = leaf
    return out


def port_leaf(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype).removeprefix("torch."))
    if isinstance(x, sharding.Placement):
        return x.spec
    return x


_STACKED = re.compile(r"^(layers|groups|encoder\.layers)\.(\d+)\.(.*)$")


def ref_name(cfg, name: str, stacked_name="groups") -> str:
    """The reference's path of the port's per-layer leaf ``name``."""
    m = _STACKED.match(name)
    if m is None:
        return name
    head, idx, rest = m.groups()
    return (f"encoder.layers.{rest}" if head == "encoder.layers"
            else f"{stacked_name}.{int(idx) % len(cfg.pattern)}.{rest}")


def ref_layout(cfg, flat: dict, *, stacked_name="groups") -> dict:
    """The port's flat per-layer leaves in the reference's stacked layout:
    ``layers.{c*npat+pi}.X`` -> ``{stacked_name}.{pi}.X`` and
    ``encoder.layers.{i}.X`` -> ``encoder.layers.X``, each shape with its
    stacked count in front and each spec with a leading ``None``; every
    stacked entry must be the same."""
    npat = len(cfg.pattern)
    groups: dict[str, list] = {}
    out = {}
    for name, leaf in flat.items():
        m = _STACKED.match(name)
        if m is None:
            out[name] = port_leaf(leaf)
            continue
        head, idx, rest = m.groups()
        key = (f"encoder.layers.{rest}" if head == "encoder.layers"
               else f"{stacked_name}.{int(idx) % npat}.{rest}")
        groups.setdefault(key, []).append(port_leaf(leaf))
    for key, leaves in groups.items():
        assert all(x == leaves[0] for x in leaves), (key, leaves)
        x = leaves[0]
        if len(x) == 2 and isinstance(x[0], tuple) and all(
                isinstance(i, int) for i in x[0]):    # (shape, dtype)
            out[key] = ((len(leaves),) + x[0], x[1])
        else:     # a spec; an empty one (replicated) stays empty
            out[key] = (None,) + tuple(x) if x else ()
    return out


@pytest.fixture(scope="module")
def cells_pod1():
    """(reference CellSpec, port CellSpec) of every cell on pod1."""
    ref_m, port_m = meshes("pod1")
    return {(a, c): (ref_shapes.input_specs(a, c, ref_m),
                     shapes.input_specs(a, c, port_m)) for a, c in CELLS}


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_params():
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import Model as RefModel
    out = {}
    for a in ARCH_IDS:
        rcfg = ref_get_config(a, "full")
        ps = jax.eval_shape(RefModel(rcfg).init, jax.random.PRNGKey(0))
        out[a] = (rcfg, ps, Model(get_config(a, "full"), device="meta"))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count(arch, full_params):
    _, ps, model = full_params[arch]
    assert shapes.param_count(model) == ref_shapes.param_count(ps)
    assert shapes.param_count(model) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count(arch, full_params):
    """Equal, but for jamba15_large: the reference scales every ``w1``/
    ``w2``/``w3`` leaf with 3 or more dims by topk/E, and its dense FFN
    leaves are 3-D once stacked over cycles ``(9, 8192, 24576)``. jamba's
    pattern has 4 dense FFN positions of 3 leaves each, so the port (which
    scales only the experts under a router) counts 7/8 of
    4 × 3 × 9 × 8192 × 24576 more."""
    rcfg, ps, model = full_params[arch]
    cfg = model.cfg
    got = shapes.active_param_count(cfg, model)
    ref = ref_shapes.active_param_count(rcfg, ps)
    if arch != "jamba15_large":
        assert got == ref
        return
    assert ref == 74_587_070_464
    dense_pos = sum(s.ffn == "dense" for s in cfg.pattern)
    leaf = cfg.n_cycles * cfg.d_model * cfg.d_ff
    assert (dense_pos, leaf) == (4, 9 * 8192 * 24576)
    assert got - ref == 3 * dense_pos * leaf * (cfg.n_experts - cfg.topk) \
        // cfg.n_experts == 19_025_362_944
    assert got == 93_612_433_408


def test_active_params_count_only_routed_experts():
    cfg = get_config("deepseek_v2_lite", "smoke")
    m = Model(cfg, device="meta")
    experts = sum(p.numel() for n, p in m.named_parameters()
                  if re.search(r"ffn\.w[123]$", n) and p.dim() == 3)
    assert shapes.active_param_count(cfg, m) == shapes.param_count(m) \
        - experts + experts * cfg.topk // cfg.n_experts


# ---------------------------------------------------------------------------
# cells, argument shapes, kv bytes
# ---------------------------------------------------------------------------

def test_shape_cells_and_support():
    assert shapes.SHAPE_CELLS == ref_shapes.SHAPE_CELLS
    assert shapes.LONG_OK == ref_shapes.LONG_OK
    assert (shapes.ENCODER_LEN, shapes.IMAGE_TOKENS) == \
        (ref_shapes.ENCODER_LEN, ref_shapes.IMAGE_TOKENS)
    for a in ARCH_IDS + ["nope"]:
        for c in shapes.SHAPE_CELLS:
            assert shapes.supports_cell(a, c) == ref_shapes.supports_cell(a, c)


def _arg_trees(ref, port, cfg):
    """Pairs (reference flat dict, port flat dict in the reference layout)
    of a cell's arguments."""
    kind = port.meta["kind"]
    out = [(ref_flat(ref.args[0]),
            ref_layout(cfg, sharding.flatten(port.args[0])))]
    if kind == "train":
        ropt = ref_flat(ref.args[1])
        popt = {}
        for k in ("mu", "nu"):
            popt.update({f"{k}.{n}": v for n, v in
                         ref_layout(cfg, port.args[1][k]).items()})
        popt["step"] = port_leaf(port.args[1]["step"])
        out.append((ropt, popt))
        out.append((ref_flat(ref.args[2]),
                    {k: port_leaf(v) for k, v in port.args[2].items()}))
    elif kind == "prefill":
        out.append((ref_flat(ref.args[1]), {"": port_leaf(port.args[1])}))
        out.append((ref_flat(ref.args[2]),
                    {k: port_leaf(v) for k, v in port.args[2].items()}))
    else:
        out.append((ref_flat(ref.args[1]), {"": port_leaf(port.args[1])}))
        rc = ref_flat(ref.args[2])
        assert rc.pop("pos") == ((), "int32")
        pc = port.args[2]
        assert pc["pos"] == port.meta["seq"] - 1
        flat = {f"layers.{k}": v for k, v in
                sharding.flatten(pc["layers"]).items()}
        pflat = ref_layout(cfg, flat, stacked_name="layers")
        if pc["xkv"] is not None:
            pflat.update({f"xkv.{k}": port_leaf(v)
                          for k, v in pc["xkv"].items()})
        else:
            assert rc.pop("xkv") is None
        out.append((rc, pflat))
    return out


@pytest.mark.parametrize("arch,cell", CELLS)
def test_cell_arguments_and_meta(arch, cell, cells_pod1):
    ref, port = cells_pod1[arch, cell]
    cfg = get_config(arch, "full")
    for r, p in _arg_trees(ref, port, cfg):
        assert r == p
    want = dict(ref.meta)
    got = dict(port.meta)
    if arch == "jamba15_large":   # test_active_param_count
        want.pop("active_params"), got.pop("active_params")
    assert got == want
    assert port.meta["kv_bytes"] > 0


# ---------------------------------------------------------------------------
# partition specs on both production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_batch_specs(arch, mesh_name):
    ref_m, port_m = meshes(mesh_name)
    ref = ref_shapes.input_specs(arch, "train_4k", ref_m)
    port = shapes.input_specs(arch, "train_4k", port_m)
    cfg = get_config(arch, "full")
    assert ref_flat(ref.in_shardings[0]) == \
        ref_layout(cfg, sharding.flatten(port.in_shardings[0]))
    assert ref_flat(ref.in_shardings[2]) == \
        {k: v.spec for k, v in port.in_shardings[2].items()}
    # the rules alone, unsanitized, agree too
    ps = shapes.param_tree(Model(cfg, device="meta"))
    rps = ref.args[0]
    assert ref_flat(ref_sharding.param_specs(rps)) == \
        ref_layout(cfg, sharding.flatten(sharding.param_specs(ps)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_specs(arch, mesh_name):
    """The port's ``zero1_specs`` on the reference's layout equals the
    reference's. On the port's per-layer tree it equals the reference's
    through the mapping wherever the reference shards a leaf's own
    dimension. Where the reference shards the cycle dimension (its stack
    of layers divides the DP size: nemotron4_340b's 96 cycles,
    rwkv6_7b's and phi35_moe's 32), a per-layer leaf has no such
    dimension, and the port shards the leaf's first divisible unsharded
    dimension instead: the same bytes on every device where it has one."""
    ref_m, port_m = meshes(mesh_name)
    ref = ref_shapes.input_specs(arch, "train_4k", ref_m)
    port = shapes.input_specs(arch, "train_4k", port_m)
    cfg = get_config(arch, "full")
    rflat = ref_flat(ref.in_shardings[1])
    # the function itself, on the reference's layout and specs
    p_ref_specs = jax.tree.map(lambda s: s.spec, ref.in_shardings[0],
                               is_leaf=lambda x: isinstance(x, NamedSharding))
    as_tuples = jax.tree.map(tuple, p_ref_specs,
                             is_leaf=lambda x: isinstance(x, P))
    got = opt_mod.zero1_specs(as_tuples, ref.args[0], port_m)
    got_p = jax.tree.map(lambda t: P(*t), got["mu"],
                         is_leaf=lambda x: isinstance(x, tuple))
    assert ref_flat(got_p) == {k[3:]: v for k, v in rflat.items()
                                   if k.startswith("mu.")}
    # the per-layer tree, through the mapping
    dp = sharding.dp_axes(port_m)
    dp_entry = dp if len(dp) > 1 else dp[0]
    moved = 0
    for k in ("mu", "nu"):
        pl = port.in_shardings[1][k]
        mapped = ref_layout(cfg, {n: v.spec for n, v in pl.items()})
        for name, spec in mapped.items():
            want = rflat[f"{k}.{name}"]
            if want == spec:
                continue
            assert want[0] == dp_entry and spec[0] is None, name
            moved += 1
    # the moments' bytes on one device: the same, but for a per-layer leaf
    # with no unsharded dimension that the DP size divides (rwkv6_7b's
    # w_base, (4096,) over "model"), which the port keeps whole per layer
    rshapes = ref_flat(ref.args[1])

    def nbytes(spec, shape):
        return math.prod(sharding.Placement(port_m, spec).shard_shape(shape))

    ref_bytes = sum(nbytes(spec, rshapes[name][0])
                    for name, spec in rflat.items() if name != "step")
    port_bytes, kept_whole = 0, set()
    for k in ("mu", "nu"):
        for n, pl in port.in_shardings[1][k].items():
            port_bytes += nbytes(pl.spec, port.args[1][k][n].shape)
            if dp_entry not in pl.spec and any(
                    e == dp_entry for e in rflat[f"{k}.{ref_name(cfg, n)}"]):
                kept_whole.add(n.split(".")[-1])
    extra = port_bytes - ref_bytes
    assert (extra > 0) == bool(kept_whole), (extra, kept_whole)
    assert kept_whole <= {"w_base"}
    assert (moved > 0) == (arch in ("nemotron4_340b", "rwkv6_7b",
                                    "phi35_moe")), moved
    assert port.in_shardings[1]["step"].spec == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,cell", [c for c in CELLS
                                       if c[1] in ("decode_32k",
                                                   "long_500k")])
def test_cache_specs(arch, cell, mesh_name):
    ref_m, port_m = meshes(mesh_name)
    ref = ref_shapes.input_specs(arch, cell, ref_m)
    port = shapes.input_specs(arch, cell, port_m)
    cfg = get_config(arch, "full")
    rc = ref_flat(ref.in_shardings[2])
    pc = port.in_shardings[2]
    flat = {f"layers.{k}": v for k, v in sharding.flatten(pc["layers"]).items()}
    got = ref_layout(cfg, flat, stacked_name="layers")
    if pc["xkv"] is not None:
        got.update({f"xkv.{k}": v.spec for k, v in pc["xkv"].items()})
    rc.pop("pos")
    rc.pop("xkv", None)
    assert rc == got
    assert ref_flat(ref.in_shardings[1]) == {"": port.in_shardings[1].spec}


def test_placement_shard_shape():
    m = DescMesh((2, 16, 16), ("pod", "data", "model"))
    pl = sharding.Placement(m, (("pod", "data"), None, "model"))
    assert pl.shard_shape((64, 3, 32)) == (2, 3, 2)
    with pytest.raises(ValueError):
        pl.shard_shape((48, 3, 32))


# ---------------------------------------------------------------------------
# meshes and the roofline (the non-HLO cases of tests/test_dryrun_smoke.py)
# ---------------------------------------------------------------------------

def test_production_mesh_shapes():
    m = make_production_mesh(multi_pod=True)
    assert m.dims == (2, 16, 16) and m.axis_names == ("pod", "data", "model")
    assert m.size == 512 and m.devices is None
    m = make_production_mesh(multi_pod=False)
    assert dict(m.shape) == {"data": 16, "model": 16} and m.size == 256
    for mp, total in ((False, 256), (True, 512)):
        for r in (1, 2, 16):
            c = make_cp_production_mesh(multi_pod=mp, replication=r)
            assert c.dims == (total // r, r) and c.axis_names == ("group",
                                                                  "sub")
    with pytest.raises(ValueError):
        make_cp_production_mesh(replication=3)


def test_roofline_terms_bottleneck():
    hw = roofline.HW()
    terms = roofline.roofline_terms(
        {"flops": hw.peak_flops, "bytes accessed": hw.hbm_bw / 2},
        {"total": 0.0})
    # exactly 1 s compute, 0.5 s memory -> compute-bound, fraction 1.0
    assert terms["bottleneck"] == "t_compute"
    assert terms["roofline_fraction"] == pytest.approx(1.0)
    terms2 = roofline.roofline_terms({"flops": 1.0,
                                      "bytes accessed": hw.hbm_bw},
                                     {"total": 0.0})
    assert terms2["bottleneck"] == "t_memory"
    terms3 = roofline.roofline_terms({}, {"total": hw.link_bw * 2},
                                     dot_flops=1.0, analytic_bytes=1.0)
    assert terms3["bottleneck"] == "t_collective"
    assert terms3["t_collective"] == pytest.approx(2.0)


def test_hw_is_the_h100():
    hw = roofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("remat", [False, True])
def test_analytic_memory_and_terms_equal_reference(kind, remat):
    meta = dict(kind=kind, chips=256, params=16_000_609_792, seq=4096,
                batch=256, d_model=2048, n_layers=27, kv_bytes=3.2e10,
                remat=remat)
    assert roofline.analytic_memory_bytes(meta) == \
        ref_rf.analytic_memory_bytes(meta)
    hw_p = roofline.HW(peak_flops=1e12, hbm_bw=2e11, link_bw=3e10)
    hw_r = ref_rf.HW(peak_flops=1e12, hbm_bw=2e11, link_bw=3e10)
    for cost, coll, kw in (
            ({"flops": 3e12, "bytes accessed": 1e11}, {"total": 1e9}, {}),
            ({"flops": 1.0}, {"total": 0.0},
             dict(dot_flops=5e11, analytic_bytes=9e11)),
            ({}, {"total": 6e10}, dict(dot_flops=1e9))):
        assert roofline.roofline_terms(cost, coll, hw_p, **kw) == \
            ref_rf.roofline_terms(cost, coll, hw_r, **kw)
    row = roofline.format_row({"arch": "a", "cell": "c"},
                              roofline.roofline_terms({"flops": 1.0}, {}))
    assert row == ref_rf.format_row({"arch": "a", "cell": "c"},
                                    ref_rf.roofline_terms({"flops": 1.0}, {}))


def test_count_flops_counts_matrix_products():
    a = torch.empty((3, 4), device="meta")
    b = torch.empty((4, 5), device="meta")
    _, f = roofline.count_flops(lambda: torch.relu(a @ b))
    assert f == 2 * 3 * 4 * 5


# ---------------------------------------------------------------------------
# run_cell: the reference's smoke lowerings, FLOPs against its HLO
# ---------------------------------------------------------------------------

SMOKE = [("granite_8b", "train_4k"), ("deepseek_v2_lite", "prefill_32k"),
         ("jamba15_large", "decode_32k"), ("rwkv6_7b", "long_500k")]


@pytest.mark.parametrize("arch,cell", SMOKE)
def test_smoke_cell_flops_equal_reference_dot_flops(arch, cell):
    """The reference's ``tests/test_dryrun_smoke.py`` cells at seq 32,
    batch 2 on a (1, 1) mesh: the port's counted matrix FLOPs equal the
    reference's loop-weighted HLO ``dot_flops`` (tolerance 0: both count
    2·M·N·K over the same products, the backward's included)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    spec = ref_shapes.input_specs(arch, cell, mesh, variant="smoke", seq=32,
                                  batch=2)
    with mesh:
        compiled = jax.jit(spec.fn, in_shardings=spec.in_shardings,
                           out_shardings=spec.out_shardings).lower(
            *spec.args).compile()
    ref = ref_rf.parse_hlo(compiled.as_text())["dot_flops"]
    rec = dryrun.run_cell(arch, cell, multi_pod=False,
                          mesh=DescMesh((1, 1), ("data", "model")),
                          variant="smoke", seq=32, batch=2, save=False)
    assert rec["ok"], rec.get("traceback")
    t = rec["roofline"]
    assert t["flops_per_chip"] == ref > 0
    assert t["bottleneck"] in ("t_compute", "t_memory", "t_collective")
    assert all(math.isfinite(t[k]) for k in
               ("t_compute", "t_memory", "t_collective"))
    assert rec["t_compile_s"] is None and rec["hlo_bytes"] is None
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def test_counted_work_equals_a_full_depth_count():
    """One cycle weighted by the cycle count = every layer run (whisper's
    training step counted from one cycle up, its encoder's backward in
    both counts)."""
    mesh = DescMesh((1, 1), ("data", "model"))
    for arch, cell in (("jamba15_large", "prefill_32k"),
                       ("gemma3_1b", "train_4k"),
                       ("whisper_small", "train_4k")):
        flops, a2a = dryrun.counted_work(arch, cell, mesh, variant="smoke",
                                         seq=32, batch=2)
        spec = shapes.input_specs(arch, cell, mesh, variant="smoke", seq=32,
                                  batch=2)
        _, full = roofline.count_flops(spec.fn, *spec.args)
        assert flops == full and a2a == 0.0


def test_a2a_cell_counts_the_all_to_all():
    """phi35_moe's smoke train cell with ``--moe-dispatch a2a`` on a (1, 4)
    mesh: forward and backward exchanges of every MoE layer, on every
    shard, and the same FLOPs as the sorted dispatch's cell but for the
    experts' capacity."""
    mesh = DescMesh((1, 4), ("data", "model"))
    rec = dryrun.run_cell("phi35_moe", "train_4k", multi_pod=False,
                          mesh=mesh, variant="smoke", seq=8, batch=4,
                          moe_dispatch="a2a", save=False)
    assert rec["ok"], rec.get("traceback")
    cfg = get_config("phi35_moe", "smoke")
    from repro_torch.models import ffn
    t_loc = 8
    s_b = min(max(1, -(-int(t_loc * cfg.topk * cfg.capacity_factor) // 4)),
              t_loc * cfg.topk)
    fwd = ffn.a2a_exchange_bytes(4, s_b, cfg.d_model, 4)
    bwd = 2 * 3 * s_b * cfg.d_model * 4
    assert rec["collectives"]["all-to-all"] == cfg.n_layers * (fwd + bwd)
    assert rec["collectives"]["total"] == rec["roofline"][
        "coll_bytes_per_chip"]
    assert rec["collectives"]["all-gather"] is None
    assert "no counterpart" in rec["collectives_null_reason"]


# ---------------------------------------------------------------------------
# the CP cell against the reference's committed record
# ---------------------------------------------------------------------------

def committed(name):
    with open(os.path.join(REPO, "experiments", "dryrun", name)) as f:
        return json.load(f)


def test_cp_cell_matches_committed_exchange_ab(tmp_path):
    want = committed("cp_amazon__exchange_ab__pod1.json")
    got = dryrun.run_cp_exchange_ab(multi_pod=False, profile="amazon",
                                    replication=1, out_dir=str(tmp_path))
    assert got["ok"] and got["same_volume"] is want["same_volume"] is True
    for v in ("ring", "overlap"):
        g, w = got["variants"][v], want["variants"][v]
        assert g["meta"]["nnz_per_dev"] == w["meta"]["nnz_per_dev"] == \
            6_803_968
        assert g["meta"]["rows_max"] == w["meta"]["rows_max"] == 18_840
        assert g["meta"] == w["meta"]
        assert g["collectives"] == w["collectives"] == {
            "collective-permute": 614_937_600.0, "total": 614_937_600.0}
        assert g["exchange"] == w["exchange"]
        assert g["mesh"] == w["mesh"] == [256, 1]
        # the reference's A/B sums every entry of its record, "total"
        # included: twice the bytes
        assert got["collective_bytes"][v] == 614_937_600.0
        assert want["collective_bytes"][v] == 2 * 614_937_600.0
    assert (tmp_path / "cp_amazon__exchange_ab__pod1.json").exists()


def test_cp_cell_bf16_wire_halves_the_committed_f32_permute(tmp_path):
    """The committed bf16-wire record says 614,937,600 B: the reference's
    CPU lowering permutes f32. The port's bf16 wire sends half."""
    want = committed("cp_amazon__r1_overlap_bf16w__pod1.json")
    got = dryrun.run_cp_cell(multi_pod=False, exchange_variant="overlap",
                             wire_dtype="bfloat16", out_dir=str(tmp_path))
    assert got["ok"] and got["cell"] == want["cell"]
    assert got["meta"] == want["meta"]
    assert want["collectives"]["total"] == 614_937_600.0
    assert got["collectives"] == {"collective-permute": 307_468_800.0,
                                  "total": 307_468_800.0}


def test_cp_cell_config_path():
    import repro_torch.api as api
    cfg = api.preset("sorted")
    rec = dryrun.run_cp_cell(multi_pod=True, config=cfg,
                             exchange_variant="allgather", save=False)
    assert rec["ok"] and rec["ec_variant"] == "sorted"
    assert rec["exchange"]["variant"] == "allgather"
    assert set(rec["collectives"]) == {"all-gather", "total"}
    assert rec["mesh"] == [512, 1]
    r2 = dryrun.run_cp_cell(multi_pod=False, replication=2, save=False)
    assert r2["collectives"]["reduce-scatter"] > 0


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_dryrun_cli_writes_records(tmp_path, capsys):
    dryrun.main(["--arch", "gemma3_1b", "--shape", "train_4k", "--mesh",
                 "pod1", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK   gemma3_1b")
    rec = json.loads((tmp_path / "gemma3_1b__train_4k__pod1.json").read_text())
    for k in ("arch", "cell", "mesh", "multi_pod", "meta", "remat",
              "microbatches", "kv_layout", "moe_dispatch", "ok", "t_lower_s",
              "t_compile_s", "memory_analysis", "cost", "collectives",
              "roofline", "hlo_bytes"):
        assert k in rec, k
    assert rec["ok"] and rec["mesh"] == [16, 16]
    dryrun.main(["--arch", "cp", "--mesh", "pod1", "--out-dir",
                 str(tmp_path)])
    assert (tmp_path / "cp_amazon__r1_ring__pod1.json").exists()
    dryrun.main(["--arch", "cp", "--mesh", "pod1", "--cp-exchange-ab",
                 "--out-dir", str(tmp_path)])
    assert "same_volume=True" in capsys.readouterr().out


def test_dryrun_cli_jobs_run_cells_in_processes(tmp_path, capsys):
    dryrun.main(["--arch", "rwkv6_7b", "--shape", "long_500k", "--mesh",
                 "both", "--jobs", "2", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:3] for line in out] == [
        ["OK", "rwkv6_7b", "long_500k"]] * 2
    assert "mesh=16x16" in out[0] and "mesh=2x16x16" in out[1]
    for tag in ("pod1", "pod2"):
        assert json.loads((tmp_path / f"rwkv6_7b__long_500k__{tag}.json")
                          .read_text())["ok"]


def test_dryrun_default_directory_is_the_ports_own():
    assert os.path.normpath(dryrun.OUT_DIR).endswith(
        os.path.join("experiments", "dryrun_torch"))


def test_dryrun_cli_fails_on_a_failed_cell(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("broken cell")
    monkeypatch.setattr(dryrun, "counted_work", broken)
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "gemma3_1b", "--shape", "decode_32k",
                     "--mesh", "pod1", "--out-dir", str(tmp_path)])
    rec = json.loads((tmp_path / "gemma3_1b__decode_32k__pod1.json")
                     .read_text())
    assert rec["ok"] is False and "broken cell" in rec["error"]


def test_quickstart_twin(capsys):
    from repro_torch.launch import quickstart
    res = quickstart.main(["--device", "cpu", "--nnz", "5000"])
    out = capsys.readouterr().out
    assert out.startswith("tensor: shape=(2000, 800, 400)")
    assert len(res.fits) == 5 and res.fits[-1] > res.fits[0]
    assert "mode 2: r=1" in out


def test_billion_profile_twin_crashes_and_resumes(tmp_path, capsys):
    from repro_torch.launch import decompose_billion_profile as bp
    args = ["--device", "cpu", "--scale", "2e-5", "--iters", "4",
            "--plan-cache", str(tmp_path / "plans"),
            "--checkpoint-dir", str(tmp_path / "ck")]
    res = bp.main(args + ["--crash-after", "2"])
    out = capsys.readouterr().out
    assert "plan: " in out and "(built)" in out
    assert "simulated crash after sweep 2" in out and res.sweeps == 2
    res2 = bp.main(args)
    out = capsys.readouterr().out
    assert "(cache hit)" in out and "sweep 3:" in out \
        and "sweep 1:" not in out
    assert res2.sweeps == 4
    whole = bp.main(["--device", "cpu", "--scale", "2e-5", "--iters", "4",
                     "--plan-cache", str(tmp_path / "plans2"),
                     "--checkpoint-dir", str(tmp_path / "ck2")])
    np.testing.assert_allclose(res2.fits, whole.fits, rtol=0, atol=1e-6)


def test_billion_profile_twin_out_of_core(tmp_path, capsys):
    from repro_torch.launch import decompose_billion_profile as bp
    res = bp.main(["--device", "cpu", "--scale", "2e-5", "--iters", "2",
                   "--out-of-core", "--store-dir", str(tmp_path / "st"),
                   "--plan-cache", str(tmp_path / "plans"),
                   "--checkpoint-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "(out-of-core" in out and res.sweeps == 2


def test_launchers_default_to_the_card():
    import inspect
    from repro_torch.launch import decompose_billion_profile, quickstart
    for mod in (quickstart, decompose_billion_profile):
        assert '"--device", default="cuda"' in inspect.getsource(mod.main)


def test_mamba_step_in_bf16_promotes_as_the_reference():
    """A bf16 Mamba decode step (jamba15_large's ``decode_32k`` cell): the
    f32 state meets the bf16 ``C`` in f32, as JAX's einsum promotes; the
    port's step equals the reference's within bf16 rounding, 2^-6 of
    max(1, max|y|) (measured 4.5e-3: the two round the gates' bf16
    products differently)."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import ssm as ref_ssm
    from repro.models.transformer import Model as RefModel
    from repro_torch.models import ssm
    from repro_torch.models.convert import _to_tensor
    rcfg = dataclasses.replace(ref_get_config("jamba15_large", "smoke"),
                               dtype="bfloat16")
    p = RefModel(rcfg).init(jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda x: x[0], p["groups"][0])["mixer"]
    pp = {k: _to_tensor(np.asarray(v)) for k, v in lp.items()
          if k != "norm1"}
    rng = np.random.default_rng(0)
    d = rcfg.d_model
    d_in = rcfg.mamba_expand * d
    x = rng.normal(size=(2, d)).astype(np.float32)
    conv = rng.normal(size=(2, rcfg.mamba_d_conv - 1, d_in)).astype(np.float32)
    h = rng.normal(size=(2, d_in, rcfg.mamba_d_state)).astype(np.float32)
    want, wstate = ref_ssm.mamba_step(
        jnp.asarray(x, jnp.bfloat16),
        {"conv": jnp.asarray(conv, jnp.bfloat16), "h": jnp.asarray(h)},
        {k: v for k, v in lp.items() if k != "norm1"})
    got, gstate = ssm.mamba_step(
        torch.from_numpy(x).bfloat16(),
        {"conv": torch.from_numpy(conv).bfloat16(),
         "h": torch.from_numpy(h)}, pp)
    assert got.dtype == torch.bfloat16 and gstate["h"].dtype == torch.float32
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.float().numpy() - want).max() <= 2 ** -6 * scale
    np.testing.assert_allclose(gstate["h"].numpy(), np.asarray(wstate["h"]),
                               rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize("variant,merge,want", [
    ("ring", "psum_scatter", {"collective-permute", "reduce-scatter"}),
    ("allgather", "psum_scatter", {"all-gather", "reduce-scatter"}),
    ("overlap", "ring_rs", {"collective-permute"})])
def test_measured_exchange_bytes_names_the_reference_collectives(
        variant, merge, want):
    """``measured_exchange_bytes`` reads the counted sends of a real
    exchange on 4 logical CPU devices (r = 2) under the reference's
    collective names, and its total is the device's counted bytes; the
    MoE's all-to-all is not exchange traffic."""
    from repro_torch import comm
    from repro_torch.comm import volume
    from repro_torch.core.mttkrp import cp_mesh
    mesh = cp_mesh(4, 2, devices=["cpu"] * 4)
    spec = comm.ExchangeSpec(variant=variant, merge=merge)
    xs = [torch.randn(8, 3) for _ in range(4)]
    volume.reset_sent_bytes()
    parts = comm.merge_partials(xs, mesh, "sub", **spec.merge_kwargs())
    comm.all_gather_axes(parts, mesh, "group", **spec.gather_kwargs())
    volume.count_sent("all_to_all", 0, 1000)
    got = volume.measured_exchange_bytes(spec, device=0)
    assert set(got["by_kind"]) == want
    assert got["total_bytes"] == volume.sent_bytes(4)[0]["total_bytes"] > 0
    assert volume.measured_exchange_bytes(spec) == got   # devices send alike
    volume.reset_sent_bytes()
    assert volume.measured_exchange_bytes(spec) == {"by_kind": {},
                                                    "total_bytes": 0.0}
    assert volume.EXCHANGE_COLLECTIVES == ref_volume.EXCHANGE_COLLECTIVES
