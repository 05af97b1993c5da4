"""The port's LM training (``repro_torch.training``, ``launch.train``,
``launch.train_lm``) against the reference's ``repro.training`` on the same
numpy inputs.

* every case of tests/test_training.py on the port, and each function
  against the reference's: AdamW (float32 and bfloat16 parameters, with
  clip and weight decay, over three steps), the clip, the cosine schedule
  at every tenth step, cross-entropy with and without a mask,
  ``zero1_specs`` (equal to ``tuple(P(...))``), the int8 round trip,
  ``SyntheticLM`` and ``MemmapCorpus`` (bitwise);
* ``compressed_psum_tree`` on 1 replica and on 4 (the reference in a
  subprocess on 4 forced host devices), two error-feedback steps, within
  2 ulps (XLA's rewrite of the scale's division; see
  ``assert_mean_close``);
* microbatches: 2 against 1 within 1e-5 (the reference test's bound), and
  against the reference's own microbatched step;
* half the ``ARCH_IDS`` smoke configs' train steps (the other half in
  tests/test_torch_train_archs.py; tests/_torch_train_cases.py);
* granite smoke's loss decreases over 8 steps;
* checkpoints: a reference-written training checkpoint resumes in the
  port's ``launch.train --device cpu`` and the other way round, each within
  1e-4 of the writer's own continuation; a resumed port run equals an
  uninterrupted one bitwise.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import _torch_train_cases as cases  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.training import compression as ref_comp  # noqa: E402
from repro.training import data as ref_data  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training import train_step as ref_ts  # noqa: E402
from repro.training.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch import train_lm as launch_train_lm  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.models.sharding import spec  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.compression import (compressed_psum_tree,  # noqa: E402
                                              dequantize_int8, quantize_int8)
from repro_torch.training.data import MemmapCorpus, SyntheticLM  # noqa: E402
from repro_torch.training.train_step import (cross_entropy,  # noqa: E402
                                             make_train_step)

ARCHS = ["gemma3_1b", "gemma2_9b", "nemotron4_340b", "phi35_moe",
         "granite_8b"]
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one thread: the suite runs files in parallel
    workers, and timing-sensitive reference tests share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_against_manual():
    cfg = opt_mod.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
                              weight_decay=0.0, grad_clip=0.0, warmup=0,
                              total_steps=10**9, min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    opt = opt_mod.adamw_init(p)
    new_p, opt, _ = opt_mod.adamw_update(cfg, p, g, opt)
    # step1: mhat = g, vhat = g², delta = g/(|g|+eps) = sign(g)
    np.testing.assert_allclose(new_p["w"].numpy(), [1.0 - 0.1, -2.0 - 0.1],
                               atol=1e-5)
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three steps with clip, weight decay and warm-up on a tree of
    parameters of ``dtype``: params, moments, lr and grad_norm against the
    reference's (float32 within 1e-6 relative; bf16 parameters within one
    bf16 ulp, 2^-8 relative: each side rounds its own f32 update)."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (5 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    cfg = opt_mod.AdamWConfig(lr=1e-2, warmup=2, total_steps=20)
    rcfg = ref_opt.AdamWConfig(lr=1e-2, warmup=2, total_steps=20)
    rp = {k: jnp.asarray(v.astype(npdt)) for k, v in p0.items()}
    ro = ref_opt.adamw_init(rp)
    pp = {k: t(v).to(getattr(torch, dtype)) for k, v in p0.items()}
    po = opt_mod.adamw_init(pp)
    for g in grads:
        rp, ro, rs = ref_opt.adamw_update(
            rcfg, rp, {k: jnp.asarray(v.astype(npdt)) for k, v in g.items()},
            ro)
        pp, po, ps = opt_mod.adamw_update(
            cfg, pp, {k: t(v).to(getattr(torch, dtype)) for k, v in g.items()},
            po)
        assert float(ps["lr"]) == pytest.approx(float(rs["lr"]), rel=1e-6)
        assert float(ps["grad_norm"]) == pytest.approx(
            float(rs["grad_norm"]), rel=1e-6)
    assert int(po["step"]) == int(ro["step"]) == 3
    ptol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    for k in shapes:
        assert pp[k].dtype == getattr(torch, dtype)
        assert cases.rel(pp[k].float().numpy(),
                         np.asarray(rp[k], np.float32)) < ptol
        for m in ("mu", "nu"):
            assert po[m][k].dtype == torch.float32
            np.testing.assert_allclose(po[m][k].numpy(), np.asarray(ro[m][k]),
                                       rtol=1e-5, atol=1e-7)


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = opt_mod.global_norm_clip(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-5)
    rg = {"a": jnp.full((4,), 10.0)}
    rc, rn = ref_opt.global_norm_clip(rg, 1.0)
    assert float(norm) == float(rn)
    np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(rc["a"]))


def test_grad_clip_promotes_bf16_like_the_reference():
    """The reference multiplies by a float32 scale array, which promotes
    bf16 grads to float32; so does the port."""
    g = {"a": torch.full((4,), 10.0, dtype=torch.bfloat16)}
    clipped, _ = opt_mod.global_norm_clip(g, 1.0)
    rc, _ = ref_opt.global_norm_clip({"a": jnp.full((4,), 10.0, jnp.bfloat16)},
                                     1.0)
    assert clipped["a"].dtype == torch.float32
    assert np.asarray(rc["a"]).dtype == np.float32
    np.testing.assert_array_equal(clipped["a"].numpy(), np.asarray(rc["a"]))


def test_cosine_schedule_shape():
    cfg = opt_mod.AdamWConfig(lr=1.0, warmup=10, total_steps=110,
                              min_lr_frac=0.1)
    rcfg = ref_opt.AdamWConfig(lr=1.0, warmup=10, total_steps=110,
                               min_lr_frac=0.1)
    lrs = [float(opt_mod.cosine_schedule(cfg, s)) for s in range(0, 120, 10)]
    assert lrs[1] == pytest.approx(1.0, rel=1e-3)       # end of warmup
    assert lrs[-1] == pytest.approx(0.1, rel=1e-2)      # min lr floor
    assert all(a >= b - 1e-6 for a, b in zip(lrs[1:], lrs[2:]))
    for s, lr in zip(range(0, 120, 10), lrs):
        want = float(ref_opt.cosine_schedule(rcfg, jnp.int32(s)))
        assert lr == pytest.approx(want, rel=1e-6, abs=1e-7), s
        dev = opt_mod.cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert dev.dtype == torch.float32 and float(dev) == lr


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_manual():
    logits = np.random.default_rng(0).normal(size=(2, 3, 5)).astype(
        np.float32)
    targets = np.asarray([[0, 1, 2], [3, 4, 0]])
    got = float(cross_entropy(t(logits), t(targets)))
    p = torch.log_softmax(t(logits), -1)
    want = -float(torch.mean(torch.take_along_dim(
        p, t(targets)[..., None], -1)))
    assert got == pytest.approx(want, rel=1e-5)
    ref = float(ref_ts.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_cross_entropy_with_mask_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7))
    mask = rng.random((3, 7)) < 0.6
    got = float(cross_entropy(t(logits), t(targets), t(mask)))
    ref = float(ref_ts.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets), jnp.asarray(mask)))
    assert got == pytest.approx(ref, rel=1e-6)
    # an all-zero mask divides by max(Σmask, 1)
    zero = np.zeros_like(mask)
    assert float(cross_entropy(t(logits), t(targets), t(zero))) == 0.0


# ---------------------------------------------------------------------------
# ZeRO-1 specs
# ---------------------------------------------------------------------------

class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 1}


class OneMesh:
    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


def test_zero1_specs_shard_moments():
    p_specs = {"w": spec(None, "model"), "n": spec()}
    shapes = {"w": torch.empty((8, 4), device="meta"),
              "n": torch.empty((6,), device="meta")}
    o = opt_mod.zero1_specs(p_specs, shapes, OneMesh())
    assert o["mu"]["w"] == tuple(P(None, "model"))
    o2 = opt_mod.zero1_specs(p_specs, shapes, FakeMesh())
    assert o2["mu"]["w"] == tuple(P("data", "model"))
    assert o2["nu"]["n"] == tuple(P("data"))
    assert o2["step"] == tuple(P())
    # against the reference on the same trees, nested and multi-axis
    rshapes = {"w": jax.ShapeDtypeStruct((8, 4), jnp.float32),
               "n": jax.ShapeDtypeStruct((6,), jnp.float32)}
    for mesh in (OneMesh(), FakeMesh()):
        ref = ref_opt.zero1_specs({"w": P(None, "model"), "n": P()}, rshapes,
                                  mesh)
        got = opt_mod.zero1_specs(p_specs, shapes, mesh)
        for k in ("mu", "nu"):
            assert {n: tuple(v) for n, v in ref[k].items()} == got[k]


def test_zero1_specs_two_dp_axes_and_nested_trees():
    class PodMesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 2, "model": 2}

    p_specs = {"layers": [{"w": spec(None, "model"), "b": spec()}],
               "odd": spec(None)}
    shapes = {"layers": [{"w": torch.empty((12, 4), device="meta"),
                          "b": torch.empty((3,), device="meta")}],
              "odd": torch.empty((6,), device="meta")}
    got = opt_mod.zero1_specs(p_specs, shapes, PodMesh())
    rshapes = {"layers": [{"w": jax.ShapeDtypeStruct((12, 4), jnp.float32),
                           "b": jax.ShapeDtypeStruct((3,), jnp.float32)}],
               "odd": jax.ShapeDtypeStruct((6,), jnp.float32)}
    ref = ref_opt.zero1_specs(
        {"layers": [{"w": P(None, "model"), "b": P()}], "odd": P(None)},
        rshapes, PodMesh())
    want = jax.tree.map(tuple, ref["mu"], is_leaf=lambda x: isinstance(x, P))
    assert got["mu"] == want
    assert got["mu"]["layers"][0]["w"] == (("pod", "data"), "model")


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000,)).astype(np.float32)
    q, s = quantize_int8(t(x))
    err = np.abs(dequantize_int8(q, s).numpy() - x).max()
    assert err <= float(s) / 2 + 1e-7
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and float(s) == float(rs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(ref_comp.dequantize_int8(rq, rs)))
    q0, s0 = quantize_int8(torch.zeros(5))
    assert float(s0) == 1.0 and not q0.any()


def test_compressed_psum_single_device():
    """n=1: compressed mean == dequantized self; residual exact; both the
    reference's in ``shard_map`` on one device, to the rounding stated
    below."""
    g = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    mean, res = compressed_psum_tree([{"w": t(g)}], [{"w": torch.zeros(64)}])
    np.testing.assert_allclose(mean["w"].numpy() + res[0]["w"].numpy(), g,
                               atol=1e-5)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    out, rres = jax.jit(shard_map(
        lambda g, r: ref_comp.compressed_psum_tree(g, r, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P())))(
        {"w": jnp.asarray(g)}, {"w": jnp.zeros(64)})
    assert_mean_close(mean["w"], out["w"])
    assert_residual_close(res[0]["w"], rres["w"], g)


# Where the two packages round differently. The jitted reference computes
# its scale ``amax / 127`` as ``amax · (1/127)`` (XLA's rewrite of a
# division by a constant; one ulp off the quotient in ~4 % of draws), and
# contracts the residual ``g32 - q·s`` into a fused multiply-add; the port
# divides, and rounds the product first. The int8 payloads are equal.

def assert_mean_close(got, want):
    """The mean within 2 float32 ulps (relative 2^-22)."""
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2.0 ** -22, atol=0)


def assert_residual_close(got, want, g32):
    """The residual within 2 ulps of max|g32|: the FMA's rounding, and the
    scale's ulp times |q| <= 127."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2 * np.spacing(np.abs(g32).max()))


def test_error_feedback_reduces_bias():
    """Mean of compressed grads over steps converges to the true mean."""
    rng = np.random.default_rng(2)
    g_true = t(rng.normal(size=(32,)).astype(np.float32))
    r = torch.zeros(32)
    acc = np.zeros(32)
    n = 50
    for _ in range(n):
        out, res = compressed_psum_tree([{"w": g_true}], [{"w": r}])
        r = res[0]["w"]
        acc += out["w"].numpy()
    np.testing.assert_allclose(acc / n, g_true.numpy(), atol=2e-3)


COMPRESS_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.training.compression import compressed_psum_tree

assert jax.device_count() == 4, jax.device_count()
inp = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()), ("data",))


def f(g, r):
    out, res = compressed_psum_tree({k: v[0] for k, v in g.items()},
                                    {k: v[0] for k, v in r.items()}, "data")
    return ({k: v[None] for k, v in out.items()},
            {k: v[None] for k, v in res.items()})


fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data"))))
names = ("a", "b", "c")
r = {k: jnp.zeros(inp[k].shape[1:], jnp.float32) for k in names}
out = {}
for s in range(inp["a"].shape[0]):
    g = {k: jnp.asarray(inp[k][s]) for k in names}
    g["c"] = g["c"].astype(jnp.bfloat16)
    m, r = fn(g, r)
    for k in names:
        out[f"mean_{k}_{s}"] = np.asarray(m[k].astype(jnp.float32))
        out[f"res_{k}_{s}"] = np.asarray(r[k])
np.savez(sys.argv[2], **out)
print("done")
"""


def test_compressed_psum_four_replicas_against_jax(tmp_path):
    """4 replicas, two error-feedback steps, leaves of f32 and bf16: the
    port's one mean tree equals every device's ``psum`` result of the
    reference (int8 payloads summed exactly in int32, one shared scale),
    and each replica's residual that device's, to the rounding stated
    above."""
    rng = np.random.default_rng(5)
    inp = {"a": rng.normal(size=(2, 4, 64)).astype(np.float32),
           "b": (3 * rng.normal(size=(2, 4, 8, 5))).astype(np.float32),
           "c": rng.normal(size=(2, 4, 16)).astype(np.float32)}
    inp["a"][1, 2] = 0.0                   # one replica all zero
    np.savez(tmp_path / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", COMPRESS_SCRIPT, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    res = [{k: torch.zeros(inp[k].shape[2:]) for k in inp} for _ in range(4)]
    for s in range(2):
        grads = [{k: t(inp[k][s, i]) for k in inp} for i in range(4)]
        for g in grads:
            g["c"] = g["c"].to(torch.bfloat16)
        g32 = [{k: g[k].float() + r[k] for k in inp}
               for g, r in zip(grads, res)]
        mean, res = compressed_psum_tree(grads, res)
        assert mean["c"].dtype == torch.bfloat16
        for k in inp:
            for i in range(4):
                assert_mean_close(mean[k], want[f"mean_{k}_{s}"][i])
                assert_residual_close(res[i][k], want[f"res_{k}_{s}"][i],
                                      g32[i][k].numpy())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_data_deterministic_and_restartable():
    d1 = SyntheticLM(vocab=100, batch=2, seq=8, seed=5)
    d2 = SyntheticLM(vocab=100, batch=2, seq=8, seed=5)
    b1, b2 = d1.batch_at(7), d2.batch_at(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(d1.batch_at(8)["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


@pytest.mark.parametrize("step", [0, 1, 7, 123])
def test_synthetic_lm_bitwise_reference(step):
    for vocab, batch, seq, seed in ((100, 2, 8, 5), (262144, 3, 33, 0)):
        got = SyntheticLM(vocab, batch, seq, seed).batch_at(step)
        want = ref_data.SyntheticLM(vocab, batch, seq, seed).batch_at(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_corpus_bitwise_reference(tmp_path, dtype):
    path = str(tmp_path / "toks.bin")
    np.arange(10_000, dtype=dtype).tofile(path)
    c = MemmapCorpus(path=path, vocab=512, batch=2, seq=16, seed=0,
                     dtype=dtype)
    b = c.batch_at(0)
    assert b["tokens"].shape == (2, 16)
    assert (b["tokens"] < 512).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    r = ref_data.MemmapCorpus(path=path, vocab=512, batch=2, seq=16, seed=0,
                              dtype=dtype)
    for step in (0, 5, 700):               # 700 wraps the window order
        got, want = c.batch_at(step), r.batch_at(step)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def granite(remat="none"):
    cfg = dataclasses.replace(get_config("granite_8b", "smoke"), remat=remat)
    tree, _, _, _ = cases.reference_step("granite_8b")
    return load_reference_params(Model(cfg, device="cpu"), tree)


def test_training_turns_gradients_on_explicitly():
    m = granite()
    assert not any(p.requires_grad for p in m.parameters())
    make_train_step(m, opt_mod.AdamWConfig())
    assert all(p.requires_grad for p in m.parameters())
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, cache = m.prefill(toks, 6)
    assert not logits.requires_grad
    logits, _ = m.decode_step(toks[:, :1], cache)
    assert not logits.requires_grad


def test_unknown_remat_raises():
    m = granite("everything")
    with pytest.raises(ValueError, match="remat"):
        m(torch.zeros((1, 4), dtype=torch.int64))


def test_microbatch_equivalence():
    """grad accumulation over 2 microbatches ≈ single big batch (1e-5, the
    reference test's bound), and the port's microbatched step against the
    reference's (1e-4)."""
    cfg = get_config("granite_8b", "smoke")
    tree, _, _, _ = cases.reference_step("granite_8b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup=0, total_steps=100)
    out = {}
    for mb in (1, 2):
        m = load_reference_params(Model(cfg, device="cpu"), tree)
        opt, met = make_train_step(m, ocfg, microbatches=mb)(
            opt_mod.adamw_init(dict(m.named_parameters())), batch)
        out[mb] = (m, met)
    assert float(out[1][1]["loss"]) == pytest.approx(
        float(out[2][1]["loss"]), rel=1e-5)
    for a, b in zip(out[1][0].parameters(), out[2][0].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)
    rm = cases.RefModel(cases.ref_get_config("granite_8b", "smoke"))
    rstep = jax.jit(ref_ts.make_train_step(
        rm, ref_opt.AdamWConfig(lr=1e-3, warmup=0, total_steps=100),
        microbatches=2))
    params = jax.tree.map(jnp.asarray, tree)
    rp, _, rmet = rstep(params, ref_opt.adamw_init(params),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    assert cases.rel(out[2][1]["loss"].numpy(), rmet["loss"]) < 1e-4
    from repro_torch.models.convert import reference_params
    for a, b in zip(jax.tree.leaves(reference_params(out[2][0])),
                    jax.tree.leaves(rp)):
        assert cases.rel(a, b) < 1e-4


def test_microbatches_must_divide_the_batch():
    m = granite()
    step = make_train_step(m, opt_mod.AdamWConfig(), microbatches=3)
    toks = np.zeros((4, 8), np.int32)
    with pytest.raises(ValueError, match="microbatches"):
        step(opt_mod.adamw_init(dict(m.named_parameters())),
             {"tokens": toks, "targets": toks})


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, remat):
    cases.check_train_step(arch, remat)


def test_smoke_loss_decreases():
    """A couple of steps on a learnable stream reduce loss (granite
    smoke), as tests/test_archs_smoke.py checks for the reference."""
    cfg = get_config("granite_8b", "smoke")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, opt_mod.AdamWConfig(
        lr=5e-3, warmup=1, total_steps=50, weight_decay=0.0))
    opt = opt_mod.adamw_init(dict(model.named_parameters()))
    data = SyntheticLM(vocab=cfg.vocab, batch=4, seq=32, seed=0)
    losses = []
    for i in range(8):
        opt, m = step(opt, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# launchers and checkpoints
# ---------------------------------------------------------------------------

def run_reference_launcher(monkeypatch, argv):
    from repro.launch import train as ref_train
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    ref_train.main()


def run_port_launcher(argv, capsys):
    launch_train.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def latest(manager_cls, path):
    payload, step = manager_cls(path).restore_latest()
    return payload, step


def assert_payloads_close(a, b, tol):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        assert np.asarray(x).shape == np.asarray(y).shape
        assert cases.rel(x, y) < tol


ARGS = ["--arch", "granite_8b", "--smoke", "--ckpt-every", "3"]


def test_reference_checkpoint_resumes_in_port_launcher(tmp_path, monkeypatch,
                                                       capsys):
    """The reference's launcher writes step 3; the port's launcher resumes
    there and trains to 6; the reference's own continuation from the same
    checkpoint agrees within 1e-4 (params and moments), step equal."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    run_reference_launcher(monkeypatch, ARGS + ["--steps", "3",
                                                "--ckpt", ref_dir])
    shutil.copytree(ref_dir, port_dir)
    capsys.readouterr()
    out = run_port_launcher(ARGS + ["--steps", "6", "--ckpt", port_dir],
                            capsys)
    assert "resumed at step 3" in out
    assert [s for s in out.splitlines() if s.startswith("step ")][0].startswith(
        "step 3 ")
    run_reference_launcher(monkeypatch, ARGS + ["--steps", "6",
                                                "--ckpt", ref_dir])
    got, gs = latest(CheckpointManager, port_dir)
    want, ws = latest(RefManager, ref_dir)
    assert gs == ws == 6 and int(got["opt"]["step"]) == 6
    assert_payloads_close(got, want, 1e-4)


def test_port_checkpoint_resumes_in_reference_launcher(tmp_path, monkeypatch,
                                                       capsys):
    """The port's launcher writes step 3 in the reference's payload layout;
    the reference's launcher resumes there (its jitted step takes the
    restored trees) and agrees with the port's own continuation within
    1e-4; the port's resumed run equals its uninterrupted run bitwise."""
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    whole_dir = str(tmp_path / "whole")
    run_port_launcher(ARGS + ["--steps", "3", "--ckpt", port_dir], capsys)
    shutil.copytree(port_dir, ref_dir)
    run_reference_launcher(monkeypatch, ARGS + ["--steps", "6",
                                                "--ckpt", ref_dir])
    assert "resumed at step 3" in capsys.readouterr().out
    out = run_port_launcher(ARGS + ["--steps", "6", "--ckpt", port_dir],
                            capsys)
    assert "resumed at step 3" in out
    run_port_launcher(ARGS + ["--steps", "6", "--ckpt", whole_dir], capsys)
    got, _ = latest(CheckpointManager, port_dir)
    want, ws = latest(RefManager, ref_dir)
    whole, _ = latest(CheckpointManager, whole_dir)
    assert ws == 6
    assert_payloads_close(got, want, 1e-4)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(whole)):
        np.testing.assert_array_equal(a, b)


def test_dry_run_names_its_slice(capsys, tmp_path, monkeypatch):
    """``--dry`` runs the dry-run's ``train_4k`` cell of ``--arch`` on the
    meta device and writes its record (``launch.dryrun.run_cell``)."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rec = launch_train.main(["--arch", "gemma3_1b", "--dry"])
    assert rec["ok"] and rec["cell"] == "train_4k"
    assert capsys.readouterr().out.startswith("OK   gemma3_1b")
    assert (tmp_path / "gemma3_1b__train_4k__pod1.json").exists()


def test_launchers_default_to_the_card():
    import inspect
    for mod in (launch_train, launch_train_lm):
        assert '"--device", default="cuda"' in inspect.getsource(mod.main)


def test_train_lm_example_twin_learns_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    launch_train_lm.main(["--device", "cpu", "--steps", "11", "--batch", "4",
                          "--seq", "16", "--ckpt", ck])
    out = capsys.readouterr().out
    assert out.startswith("granite-8b-smoke: ")
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert CheckpointManager(ck).steps() == [10]
    launch_train_lm.main(["--device", "cpu", "--steps", "11", "--batch", "4",
                          "--seq", "16", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "resumed from step 10" in out and "step   10" in out
