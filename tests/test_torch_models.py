"""The port's LM substrate (``repro_torch.models``) against the reference's
``repro.models`` on the same weights.

Every case of ``tests/test_models.py::CASES`` is initialised by the
reference (``Model.init`` with a JAX key) and carried into the port by
``load_reference_params``. The same token ids, made from a seed with numpy,
go through both packages in float32 on the CPU. Logits agree within
``TOL × max(1, max|ref|)``, prefill caches (mapped to the reference's
layout by ``reference_cache``) within ``TOL × max(1, max|ref|)`` per leaf.
The mixers' own properties (causality, the local window, chunked = scan,
Mamba scan = step, MoE dispatch = dense oracle, capacity drops, the load)
are held against the reference function on the same inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ffn as ref_ffn  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.models.transformer import ModelConfig as RefConfig  # noqa: E402
from repro_torch.models import ffn, ssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_cache, reference_params)

TOL = 1e-4  # × max(1, max|ref|), float32 on the CPU

BASE = dict(d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=97, dtype="float32", attn_chunk=8, rwkv_chunk=4)

CASE_KW = {
    "gqa": {},
    "local_softcap": dict(pattern=({"window": 6, "attn_softcap": 30.0},)),
    "moe": dict(pattern=({"ffn": "moe"},), n_experts=4, topk=2,
                moe_d_ff=32, capacity_factor=64.0),
    "mla": dict(pattern=({"mixer": "mla"},), kv_lora=16, qk_nope_dim=8,
                qk_rope_dim=4, v_head_dim=8),
    "mamba": dict(pattern=({"mixer": "mamba"},)),
    "rwkv6": dict(pattern=({"mixer": "rwkv6", "ffn": "rwkv_cm"},),
                  rwkv_head_dim=8),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these small models on one thread: the suite runs
    files in parallel workers, and timing-sensitive reference tests share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name, **over):
    """The case as (reference config, port config) with equal fields."""
    import repro.models.transformer as rt
    kw = {**BASE, **CASE_KW[name], **over}
    pat = kw.pop("pattern", ({},))
    ref = RefConfig(name=name, pattern=tuple(rt.LayerSpec(**p) for p in pat),
                    **kw)
    port = tt.ModelConfig(name=name, pattern=tuple(
        tt.LayerSpec(**p) for p in pat), **kw)
    return ref, port


def pair(name, **over):
    """Reference model + params and the port model with the same weights."""
    rcfg, pcfg = configs(name, **over)
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    pm = load_reference_params(tt.Model(pcfg, device="cpu"), tree)
    return rm, params, pm


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(CASE_KW))
def test_forward_matches_reference(name):
    rm, params, pm = pair(name)
    toks = tokens(rm.cfg, 2, 12)
    ref = np.asarray(rm.forward(params, jnp.asarray(toks)))
    got = pm(t(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel_err(got, ref) < TOL, rel_err(got, ref)


@pytest.mark.parametrize("name", list(CASE_KW))
def test_prefill_decode_and_caches_match_reference(name):
    """Prefill logits and three decode steps agree with the reference's,
    and so do the prefill caches; prefill + decode also agree with the
    port's own forward (the reference test's bound, 2e-2)."""
    rm, params, pm = pair(name)
    B, S = 2, 12
    toks = tokens(rm.cfg, B, S)
    s0 = S - 3
    rlg, rcache = rm.prefill(params, jnp.asarray(toks[:, :s0]), cache_len=S)
    plg, pcache = pm.prefill(t(toks[:, :s0]), S)
    assert pcache["pos"] == s0
    assert rel_err(plg.numpy(), rlg) < TOL
    got_c = reference_cache(pm, pcache["layers"])
    ref_c = jax.tree.map(np.asarray, rcache["layers"])
    assert jax.tree.structure(got_c) == jax.tree.structure(ref_c)
    for g, r in zip(jax.tree.leaves(got_c), jax.tree.leaves(ref_c)):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert rel_err(g, r) < TOL
    full = pm(t(toks)).numpy()
    errs = [np.abs(plg.numpy()[:, -1] - full[:, s0 - 1]).max()]
    for i in range(3):
        step = toks[:, s0 + i:s0 + i + 1]
        rlg, rcache = rm.decode_step(params, jnp.asarray(step), rcache)
        plg, pcache = pm.decode_step(t(step), pcache)
        assert rel_err(plg.numpy(), rlg) < TOL, (i, rel_err(plg.numpy(), rlg))
        errs.append(np.abs(plg.numpy()[:, 0] - full[:, s0 + i]).max())
    assert max(errs) / max(1.0, np.abs(full).max()) < 2e-2, errs


def test_causality():
    """Future tokens do not affect past logits, in both packages alike."""
    rm, params, pm = pair("gqa")
    toks = tokens(rm.cfg, 1, 10)
    toks2 = toks.copy()
    toks2[0, 7] = (toks[0, 7] + 1) % rm.cfg.vocab
    base, pert = pm(t(toks)).numpy(), pm(t(toks2)).numpy()
    np.testing.assert_allclose(base[:, :7], pert[:, :7], atol=1e-5)
    assert np.abs(base[:, 7:] - pert[:, 7:]).max() > 1e-6
    ref = np.asarray(rm.forward(params, jnp.asarray(toks2)))
    assert rel_err(pert, ref) < TOL


def test_local_window_restricts_context():
    """With window 3, one layer: logits at t depend only on tokens in
    (t-3, t]; the perturbed run agrees with the reference's."""
    rm, params, pm = pair("gqa", n_layers=1, pattern=({"window": 3},))
    toks = tokens(rm.cfg, 1, 12, seed=2)
    toks2 = toks.copy()
    toks2[0, 2] = (toks[0, 2] + 1) % rm.cfg.vocab
    base, pert = pm(t(toks)).numpy(), pm(t(toks2)).numpy()
    np.testing.assert_allclose(base[:, 5:], pert[:, 5:], atol=1e-5)
    assert np.abs(base[:, 2] - pert[:, 2]).max() > 1e-6
    ref = np.asarray(rm.forward(params, jnp.asarray(toks2)))
    assert rel_err(pert, ref) < TOL


@pytest.mark.parametrize("s,chunk,window", [
    (12, 8, None),     # gcd chunk 4, 6 causal pairs
    (13, 8, None),     # prime length: chunk 1, 91 pairs batched per key
    (12, 8, 5),
    (13, 4, 6),
    (32, 8, 3),
])
def test_attention_prefill_chunking_matches_reference(s, chunk, window):
    """The stacked chunk loop against the reference's lax.map/scan, on
    lengths that shrink the chunk to gcd(s, chunk), with softcap."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 6)).astype(np.float32)
    for causal in (True, False) if window is None else (True,):
        for skip in (True, False):
            kw = dict(causal=causal, window=window, cap=20.0, chunk=chunk,
                      block_skip=skip)
            ref = np.asarray(ref_attn.attention_prefill(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
            got = attention.attention_prefill(t(q), t(k), t(v), **kw).numpy()
            assert rel_err(got, ref) < TOL, (kw, rel_err(got, ref))


def layer0_mixer(name, **over):
    rcfg, _ = configs(name, **over)
    p = RefModel(rcfg).init(jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda x: x[0], p["groups"][0])
    return lp["mixer"], jax.tree.map(lambda a: t(np.asarray(a)), lp["mixer"])


@pytest.mark.parametrize("chunk", [1, 4, 6, 24])
def test_rwkv_chunked_equals_scan(chunk):
    """The port's chunked form equals its scan (the reference test's
    2e-3) and the reference's chunked form (TOL)."""
    rp, pp = layer0_mixer("rwkv6", d_model=16, rwkv_head_dim=4,
                          pattern=({"mixer": "rwkv6"},))
    x = np.random.default_rng(0).normal(size=(2, 24, 16)).astype(np.float32)
    scan = ssm.rwkv6_scan(t(x), pp).numpy()
    assert rel_err(scan, ref_ssm.rwkv6_scan(jnp.asarray(x), rp)) < TOL
    got = ssm.rwkv6_chunked(t(x), pp, chunk=chunk).numpy()
    np.testing.assert_allclose(got, scan, rtol=2e-3, atol=2e-3)
    ref = np.asarray(ref_ssm.rwkv6_chunked(jnp.asarray(x), rp, chunk=chunk))
    assert rel_err(got, ref) < TOL


def test_mamba_scan_step_consistency():
    rp, pp = layer0_mixer("mamba", d_model=16)
    x = np.random.default_rng(1).normal(size=(2, 10, 16)).astype(np.float32)
    full = ssm.mamba_scan(t(x), pp).numpy()
    assert rel_err(full, ref_ssm.mamba_scan(jnp.asarray(x), rp)) < TOL
    state = {"conv": torch.zeros(2, 3, 32), "h": torch.zeros(2, 32, 16)}
    outs = []
    for i in range(10):
        y, state = ssm.mamba_step(t(x[:, i]), state, pp)
        outs.append(y.numpy())
    np.testing.assert_allclose(full, np.stack(outs, axis=1), rtol=1e-4,
                               atol=1e-4)


def moe_params(rng, d, e, f, scale=0.1, zero_router=False):
    p = {"router": np.zeros((d, e), np.float32) if zero_router
         else rng.normal(size=(d, e)).astype(np.float32),
         "w1": rng.normal(size=(e, d, f)).astype(np.float32) * scale,
         "w3": rng.normal(size=(e, d, f)).astype(np.float32) * scale,
         "w2": rng.normal(size=(e, f, d)).astype(np.float32) * scale}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: t(v) for k, v in p.items()})


def test_moe_dispatch_equivalence():
    """sort- and scatter-dispatch == dense oracle when capacity is ample,
    in the port; each equals the reference's, and so does the load."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 16)).astype(np.float32)
    rp, pp = moe_params(rng, 16, 4, 32)
    dense = ffn.moe_ref_dense(t(x), pp, topk=2).numpy()
    assert rel_err(dense, ref_ffn.moe_ref_dense(jnp.asarray(x), rp,
                                                topk=2)) < TOL
    for disp in ("sort", "scatter"):
        got, aux = ffn.moe(t(x), pp, topk=2, capacity_factor=4.0,
                           dispatch=disp)
        np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4)
        ref, raux = ref_ffn.moe(jnp.asarray(x), rp, topk=2,
                                capacity_factor=4.0, dispatch=disp)
        assert rel_err(got.numpy(), ref) < TOL
        np.testing.assert_array_equal(aux["load"].numpy(),
                                      np.asarray(raux["load"]))
        assert float(aux["load"].sum()) == pytest.approx(1.0, abs=1e-5)
        assert rel_err(aux["router_z"].numpy(), raux["router_z"]) < TOL


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
def test_moe_capacity_drops_tokens(dispatch):
    """An all-zero router ties every logit: the top-k must break ties by the
    lower index as lax.top_k does, so the same copies are dropped."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    rp, pp = moe_params(rng, 8, 4, 16, scale=1.0, zero_router=True)
    tight, aux = ffn.moe(t(x), pp, topk=2, capacity_factor=0.25,
                         dispatch=dispatch)
    ample, _ = ffn.moe(t(x), pp, topk=2, capacity_factor=8.0,
                       dispatch=dispatch)
    assert np.abs(tight.numpy() - ample.numpy()).max() > 1e-6
    ref, raux = ref_ffn.moe(jnp.asarray(x), rp, topk=2, capacity_factor=0.25,
                            dispatch=dispatch)
    assert rel_err(tight.numpy(), ref) < TOL
    np.testing.assert_array_equal(aux["load"].numpy(),
                                  np.asarray(raux["load"]))


def test_topk_ties_go_to_the_lower_index():
    logits = torch.tensor([[0.0, 1.0, 1.0, 0.0, 1.0]])
    _, idx = ffn._topk_gates(logits, 3)
    assert idx.tolist() == [[1, 2, 4]]
    _, ridx = ref_ffn._topk_gates(jnp.asarray(logits.numpy()), 3)
    assert np.asarray(ridx).tolist() == idx.tolist()


@pytest.mark.parametrize("name", list(CASE_KW))
def test_reference_params_round_trip(name):
    rm, params, pm = pair(name)
    tree = jax.tree.map(np.asarray, params)
    back = reference_params(pm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bf16_params_round_trip_bitwise():
    """bfloat16 leaves (ml_dtypes arrays, as JAX gives them) cross both ways
    through their bit patterns."""
    rcfg, pcfg = configs("moe", dtype="bfloat16")
    params = RefModel(rcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    pm = load_reference_params(tt.Model(pcfg, device="cpu"), tree)
    assert pm["embed"].dtype == torch.bfloat16
    assert pm["layers"][0]["ffn"]["router"].dtype == torch.float32
    back = reference_params(pm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_load_rejects_a_wrong_tree():
    rm, params, pm = pair("gqa")
    tree = jax.tree.map(np.asarray, params)
    tree["groups"][0]["mixer"]["wq"] = tree["groups"][0]["mixer"]["wq"][:, :, :4]
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(pm, tree)
    del tree["groups"][0]["mixer"]["wq"]
    with pytest.raises(ValueError, match="leaves differ"):
        load_reference_params(pm, tree)


def test_port_init_is_seeded_and_device_explicit():
    """The port's own init: the same generator seed gives the same weights,
    another seed others; the fan-in scale and truncation hold."""
    _, cfg = configs("moe")
    a = tt.Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(5))
    b = tt.Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(5))
    c = tt.Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    wq = sa["layers.0.mixer.wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    assert all(not p.requires_grad for p in a.parameters())
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(cfg)
