"""The port's expert-parallel MoE (``repro_torch.models.ffn.moe_a2a``) on 4
logical CPU devices, against the reference's ``repro.models.ffn.moe_a2a``
inside ``shard_map`` on 4 JAX CPU devices.

One subprocess (module-scoped; ``XLA_FLAGS`` forces 4 host devices, which
the main test process must not set) runs the reference on a (1, 4)
``("data", "model")`` mesh over the inputs this module writes: the MoE
layers of the deepseek_v2_lite, phi35_moe and jamba15_large smoke configs
(8 experts over 4 shards, so 2 local experts each, and 4 experts, 1 each:
both branches of ``_local_expert_ffn``), seeded numpy weights, f32, at the
config's capacity factor and at 0.25, where buckets overflow and copies are
dropped; a batch of 2, which does not divide the 4 shards, takes the
batch × sequence boundary. It also runs one deepseek_v2_lite smoke
``forward`` with ``moe_dispatch="a2a"`` under the ``moe_axes`` hint, on
``Model.init(PRNGKey(0))``'s weights, which the port loads through
``models.convert``.

Tolerance: 1e-5 × max(1, max|ref|) for the MoE layer (the same routing,
buckets and drops, so only the f32 products' summation order differs;
measured 2.4e-7 to 9.3e-7), 1e-4 × max(1, max|ref|) for the model's logits (the
models tests' bound). The routing decisions are held exactly: the rows the
reference zeroes (every copy dropped) are the port's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.comm import volume  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import DescMesh  # noqa: E402
from repro_torch.models import ffn, shardctx  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

FFN_TOL = 1e-5
MODEL_TOL = 1e-4
ARCHS = ("deepseek_v2_lite", "phi35_moe", "jamba15_large")
# (arch, capacity factor or None for the config's, batch, seq)
CASES = {f"{a}_{tag}": (a, cf, b, 8) for a in ARCHS
         for tag, cf, b in (("cfg", None, 4), ("overflow", 0.25, 4))}
CASES["deepseek_v2_lite_seqsplit"] = ("deepseek_v2_lite", None, 2, 8)

SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import ffn, shardctx
from repro.models.transformer import Model
import dataclasses

assert jax.device_count() == 4, jax.device_count()
inp = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()).reshape(1, 4), ("data", "model"))
out = {}
names = sorted({k.split("/")[0] for k in inp if "/" in k})
with mesh:
    for name in names:
        g = lambda k: jnp.asarray(inp[f"{name}/{k}"])
        meta = inp[f"{name}/meta"]
        topk, cf = int(meta[0]), float(meta[1])
        act = str(inp[f"{name}/act"])
        p = {k: g(k) for k in ("router", "w1", "w2", "w3")}
        fn = jax.jit(lambda x, p: ffn.moe_a2a(
            x, p, topk=topk, capacity_factor=cf, act=act, dp_axes=("data",),
            ep_axis="model", mesh=mesh)[0])
        out[name] = np.asarray(fn(g("x"), p))
    cfg = dataclasses.replace(get_config("deepseek_v2_lite", "smoke"),
                              moe_dispatch="a2a")
    model = Model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    axes = {"mesh": mesh, "dp": ("data",), "ep": "model", "dp_size": 1,
            "ep_size": 4}
    def fwd(params, toks):
        with shardctx.hints(moe_axes=axes):
            return model.forward(params, toks)
    out["model_logits"] = np.asarray(jax.jit(fwd)(params,
                                                  jnp.asarray(inp["tokens"])))
np.savez(sys.argv[2], **out)
"""


def layer_inputs(arch, cf, b, s, seed):
    cfg = get_config(arch, "smoke")
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    return cfg, {
        "x": rng.normal(size=(b, s, d)).astype(np.float32),
        "router": rng.normal(size=(d, e)).astype(np.float32),
        "w1": (0.2 * rng.normal(size=(e, d, f))).astype(np.float32),
        "w2": (0.2 * rng.normal(size=(e, f, d))).astype(np.float32),
        "w3": (0.2 * rng.normal(size=(e, d, f))).astype(np.float32),
        "meta": np.asarray([cfg.topk, cfg.capacity_factor if cf is None
                            else cf], np.float64),
        "act": np.asarray(cfg.mlp_kind)}


def model_tokens():
    cfg = get_config("deepseek_v2_lite", "smoke")
    return np.random.default_rng(7).integers(0, cfg.vocab, (4, 8)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_moe_a2a")
    inp = {"tokens": model_tokens()}
    for i, (name, case) in enumerate(CASES.items()):
        _, arrays = layer_inputs(*case, seed=i)
        inp.update({f"{name}/{k}": v for k, v in arrays.items()})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def mesh4():
    return DescMesh((1, 4), ("data", "model"), devices=["cpu"] * 4)


def port_layer(cfg, arrays, cf):
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "w1", "w2", "w3")}
    return ffn.moe_a2a(torch.from_numpy(arrays["x"]), p, topk=cfg.topk,
                       capacity_factor=float(arrays["meta"][1]),
                       act=cfg.mlp_kind, dp_axes=("data",), ep_axis="model",
                       mesh=mesh4())[0].numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_moe_a2a_matches_reference(name, jax_out):
    i = list(CASES).index(name)
    arch, cf, b, s = CASES[name]
    cfg, arrays = layer_inputs(arch, cf, b, s, seed=i)
    got = port_layer(cfg, arrays, cf)
    ref = jax_out[name]
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= FFN_TOL * scale
    # the same copies dropped: the same rows left all zero
    np.testing.assert_array_equal((got == 0).all(-1), (ref == 0).all(-1))


def test_overflow_cases_drop_copies(jax_out):
    """At capacity factor 0.25 the buckets overflow: the result differs
    from the capacity-free dense oracle, in both packages."""
    for arch in ARCHS:
        name = f"{arch}_overflow"
        i = list(CASES).index(name)
        cfg, arrays = layer_inputs(*CASES[name], seed=i)
        p = {k: torch.from_numpy(arrays[k])
             for k in ("router", "w1", "w2", "w3")}
        x = torch.from_numpy(arrays["x"])
        dense = ffn.moe_ref_dense(x.reshape(-1, x.shape[-1]), p,
                                  topk=cfg.topk, act=cfg.mlp_kind)
        assert np.abs(dense.reshape(x.shape).numpy()
                      - jax_out[name]).max() > 1e-3


def test_both_local_expert_branches_are_covered():
    e_loc = {a: get_config(a, "smoke").n_experts // 4 for a in ARCHS}
    assert e_loc["deepseek_v2_lite"] == 2
    assert e_loc["phi35_moe"] == e_loc["jamba15_large"] == 1


def test_model_forward_a2a_matches_reference(jax_out):
    import dataclasses
    rcfg = dataclasses.replace(ref_get_config("deepseek_v2_lite", "smoke"),
                               moe_dispatch="a2a")
    params = RefModel(rcfg).init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(get_config("deepseek_v2_lite", "smoke"),
                               moe_dispatch="a2a")
    pm = load_reference_params(Model(pcfg, device="cpu"),
                               jax.tree.map(np.asarray, params))
    axes = {"mesh": mesh4(), "dp": ("data",), "ep": "model", "dp_size": 1,
            "ep_size": 4}
    volume.reset_sent_bytes()
    with torch.no_grad(), shardctx.hints(moe_axes=axes):
        got = pm(torch.from_numpy(model_tokens())).numpy()
    sent = [volume.sent_by_kind(k).get("all_to_all", 0) for k in range(4)]
    volume.reset_sent_bytes()
    ref = jax_out["model_logits"]
    assert np.abs(got - ref).max() <= MODEL_TOL * max(1.0, np.abs(ref).max())
    # every MoE layer sent its buckets out and back on every shard
    t_loc = 4 * 8 // 4
    s_b = min(max(1, -(-int(t_loc * pcfg.topk * pcfg.capacity_factor) // 4)),
              t_loc * pcfg.topk)
    n_moe = sum(s.ffn == "moe" for s in pcfg.layers)
    assert sent == [n_moe * ffn.a2a_exchange_bytes(4, s_b, pcfg.d_model, 4)] * 4


def test_a2a_equals_sort_dispatch_without_drops():
    """At a capacity no bucket overflows, a2a = the sorted dispatch = the
    dense oracle (to f32 summation order)."""
    cfg, arrays = layer_inputs("deepseek_v2_lite", 64.0, 4, 8, seed=11)
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "w1", "w2", "w3")}
    x = torch.from_numpy(arrays["x"])
    a2a = port_layer(cfg, arrays, 64.0)
    flat = x.reshape(-1, x.shape[-1])
    sort, _ = ffn.moe(flat, p, topk=cfg.topk, capacity_factor=64.0,
                      act=cfg.mlp_kind)
    dense = ffn.moe_ref_dense(flat, p, topk=cfg.topk, act=cfg.mlp_kind)
    np.testing.assert_allclose(a2a, sort.reshape(x.shape).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(a2a, dense.reshape(x.shape).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_counted_bytes_equal_the_model(cf):
    """Each shard sends ``a2a_exchange_bytes``: its payload out and the
    outputs back, ``2 (ep-1) s_b d`` elements, and ``(ep-1) s_b`` int32
    expert ids; the backward sends the gradients the same way."""
    cfg, arrays = layer_inputs("phi35_moe", cf, 4, 8, seed=3)
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "w1", "w2", "w3")}
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    volume.reset_sent_bytes()
    out, _ = ffn.moe_a2a(x, p, topk=cfg.topk, capacity_factor=cf,
                         act=cfg.mlp_kind, dp_axes=("data",), ep_axis="model",
                         mesh=mesh4())
    t_loc = 8
    s_b = min(max(1, -(-int(t_loc * cfg.topk * cf) // 4)), t_loc * cfg.topk)
    want = ffn.a2a_exchange_bytes(4, s_b, cfg.d_model, 4)
    assert [volume.sent_by_kind(k)["all_to_all"] for k in range(4)] == \
        [want] * 4
    out.sum().backward()
    # the ids carry no gradient: only the two payload exchanges return
    back = 2 * 3 * s_b * cfg.d_model * 4
    assert [volume.sent_by_kind(k)["all_to_all"] for k in range(4)] == \
        [want + back] * 4
    assert volume.measured_exchange_bytes()["total_bytes"] == 0.0
    volume.reset_sent_bytes()


def test_a2a_runs_on_meta_tensors():
    cfg = get_config("deepseek_v2_lite", "smoke")
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    p = {"router": m(d, e), "w1": m(e, d, f), "w2": m(e, f, d),
         "w3": m(e, d, f)}
    out, _ = ffn.moe_a2a(m(4, 8, d), p, topk=cfg.topk, capacity_factor=1.25,
                         act="swiglu", dp_axes=("data",), ep_axis="model",
                         mesh=DescMesh((1, 4), ("data", "model")))
    assert out.shape == (4, 8, d) and out.device.type == "meta"
    volume.reset_sent_bytes()


def test_a2a_rejects_a_batch_that_does_not_split():
    cfg, arrays = layer_inputs("phi35_moe", None, 3, 6, seed=0)
    with pytest.raises(ValueError, match="splits neither"):
        port_layer(cfg, arrays, None)


def test_count_dropped_counts_both_dispatches():
    """``count_dropped`` totals the copies each dispatch drops for
    capacity: none at a capacity where nothing overflows, some at 0.25."""
    cfg, arrays = layer_inputs("deepseek_v2_lite", 0.25, 4, 8, seed=5)
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "w1", "w2", "w3")}
    x = torch.from_numpy(arrays["x"])
    flat = x.reshape(-1, x.shape[-1])
    for cf, dropping in ((64.0, False), (0.25, True)):
        with ffn.count_dropped() as sort_drops:
            ffn.moe(flat, p, topk=cfg.topk, capacity_factor=cf,
                    act=cfg.mlp_kind)
        with ffn.count_dropped() as a2a_drops:
            ffn.moe_a2a(x, p, topk=cfg.topk, capacity_factor=cf,
                        act=cfg.mlp_kind, dp_axes=("data",), ep_axis="model",
                        mesh=mesh4())
        assert (sort_drops["copies"] > 0) == dropping
        assert (a2a_drops["copies"] > 0) == dropping
    # outside the block nothing is collected
    ffn.moe(flat, p, topk=cfg.topk, capacity_factor=0.25, act=cfg.mlp_kind)
    assert ffn._DROPPED is None
    volume.reset_sent_bytes()
