"""The port's architecture registry (``repro_torch.configs``) against the
reference's, for every id of ``ARCH_IDS``.

* every ``full()`` and ``smoke()`` config equals the reference's, field for
  field;
* each smoke config's forward (with ``frames`` / ``images`` where the family
  takes them, as ``tests/test_archs_smoke.py::_extra_for`` does) agrees with
  the reference's on the reference's weights within
  ``TOL × max(1, max|ref|)`` in float32 on the CPU, and so do its prefill
  and three decode steps;
* every FULL config's port model, built on the meta device, has the
  reference's parameter shapes, dtypes and count (``jax.eval_shape`` of the
  reference's ``init``);
* ``reference_params(load_reference_params(m, tree))`` gives ``tree`` back
  bitwise;
* in bfloat16, the served archs keep the reference's dtypes in every
  parameter and cache leaf (their logits within ``BF16_TOL``, below).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, _ALIASES, get_config  # noqa: E402
from repro_torch.models.convert import (_walk,  # noqa: E402
                                        load_reference_params,
                                        reference_cache, reference_params)
from repro_torch.models.transformer import Model  # noqa: E402

TOL = 1e-4  # × max(1, max|ref|), float32 on the CPU
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these small models on one thread: the suite runs
    files in parallel workers, and timing-sensitive reference tests share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def extra_for(cfg, batch):
    """The reference test's extras, as numpy."""
    rng = np.random.default_rng(0)
    if cfg.encoder is not None:
        return {"frames": rng.normal(size=(batch, 12, cfg.d_model)
                                     ).astype(np.float32)}
    if any(s.mixer == "cross_attn" for s in cfg.pattern):
        return {"images": rng.normal(size=(batch, 10, cfg.d_model)
                                     ).astype(np.float32)}
    return None


def smoke_pair(arch):
    rcfg = ref_get_config(arch, "smoke")
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    pm = load_reference_params(Model(get_config(arch, "smoke"),
                                     device="cpu"), tree)
    return rm, params, tree, pm


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def test_registry_ids_and_aliases():
    import repro.configs as rc
    assert ARCH_IDS == REF_ARCH_IDS
    assert _ALIASES == rc._ALIASES
    for alias, key in _ALIASES.items():
        assert get_config(alias, "smoke") == get_config(key, "smoke")


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference(arch, variant):
    got = dataclasses.asdict(get_config(arch, variant))
    want = dataclasses.asdict(ref_get_config(arch, variant))
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_prefill_decode_match_reference(arch):
    rm, params, _, pm = smoke_pair(arch)
    cfg = rm.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    ex = extra_for(cfg, B)
    rex = None if ex is None else {k: jnp.asarray(v) for k, v in ex.items()}
    pex = None if ex is None else {k: torch.from_numpy(v)
                                   for k, v in ex.items()}
    ref = np.asarray(rm.forward(params, jnp.asarray(toks), extra=rex))
    got = pm(torch.from_numpy(toks), extra=pex).numpy()
    assert got.shape == (B, S, cfg.vocab) and np.isfinite(got).all()
    assert rel_err(got, ref) < TOL, rel_err(got, ref)
    s0 = S - 3
    rlg, rc = rm.prefill(params, jnp.asarray(toks[:, :s0]), S, extra=rex)
    plg, pc = pm.prefill(torch.from_numpy(toks[:, :s0]), S, extra=pex)
    assert rel_err(plg.numpy(), rlg) < TOL
    for i in range(3):
        step = toks[:, s0 + i:s0 + i + 1]
        rlg, rc = rm.decode_step(params, jnp.asarray(step), rc)
        plg, pc = pm.decode_step(torch.from_numpy(step), pc)
        assert rel_err(plg.numpy(), rlg) < TOL, (i, rel_err(plg.numpy(), rlg))


def ref_layout_shapes(model: Model) -> dict:
    """The port model's parameters as reference-layout paths →
    (shape, dtype name): per-layer trees stacked over cycles (encoder
    layers over layers). Works on the meta device."""
    cfg = model.cfg
    npat = len(cfg.pattern)
    out = {}
    for name in ("embed", "pos_emb"):
        if name in model:
            out[name] = (tuple(model[name].shape), str(model[name].dtype))
    for path, _, p in _walk(model["final_norm"]):
        out[f"final_norm.{path}"] = (tuple(p.shape), str(p.dtype))
    for pi in range(npat):
        for path, _, p in _walk(model["layers"][pi]):
            out[f"groups.{pi}.{path}"] = ((cfg.n_cycles, *p.shape),
                                          str(p.dtype))
    if "encoder" in model:
        enc = model["encoder"]
        for path, _, p in _walk(enc["layers"][0]):
            out[f"encoder.layers.{path}"] = ((len(enc["layers"]), *p.shape),
                                             str(p.dtype))
        for path, _, p in _walk(enc["final_norm"]):
            out[f"encoder.final_norm.{path}"] = (tuple(p.shape), str(p.dtype))
    return out


def jax_shapes(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), "torch." + str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_shapes_match_reference(arch):
    cfg = get_config(arch, "full")
    m = Model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in m.parameters())
    got = ref_layout_shapes(m)
    want = jax_shapes(jax.eval_shape(RefModel(ref_get_config(arch, "full"))
                                     .init, jax.random.PRNGKey(0)))
    assert got == want
    count = sum(p.numel() for p in m.parameters())
    assert count == sum(int(np.prod(s)) for s, _ in want.values())
    # every layer of the pattern carries the same tree in every cycle
    for l, lp in enumerate(m["layers"]):
        first = m["layers"][l % len(cfg.pattern)]
        assert [(p, tuple(x.shape)) for p, _, x in _walk(lp)] == \
            [(p, tuple(x.shape)) for p, _, x in _walk(first)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reference_params_round_trip_bitwise(arch):
    _, _, tree, pm = smoke_pair(arch)
    back = reference_params(pm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# bf16 against the reference: XLA fuses each elementwise chain and rounds
# once where eager PyTorch rounds after every operation, so the two differ
# by bf16 roundings, not by f32 ones. Measured on these smoke configs (seed
# 1 tokens, B 2, S 16): gemma3_1b 7.5e-3, deepseek_v2_lite 1.2e-2 of
# max(1, max|ref|).
BF16_TOL = 3e-2


@pytest.mark.parametrize("arch", ["gemma3_1b", "deepseek_v2_lite"])
def test_bf16_smoke_matches_reference_dtypes_and_logits(arch):
    """The two full-width archs served in bf16 on the card, at smoke size
    in bf16 on the CPU: every parameter and cache leaf has the reference's
    dtype, and the logits agree within BF16_TOL."""
    rcfg = dataclasses.replace(ref_get_config(arch, "smoke"), dtype="bfloat16")
    pcfg = dataclasses.replace(get_config(arch, "smoke"), dtype="bfloat16")
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    pm = load_reference_params(Model(pcfg, device="cpu"),
                               jax.tree.map(np.asarray, params))
    back = reference_params(pm)
    assert [str(a.dtype) for a in jax.tree.leaves(back)] == \
        [str(np.asarray(a).dtype) for a in jax.tree.leaves(params)]
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S))
    ref = np.asarray(rm.forward(params, jnp.asarray(toks)))
    got = pm(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), ref) < BF16_TOL, rel_err(got.numpy(), ref)
    _, rc = rm.prefill(params, jnp.asarray(toks[:, :S - 3]), S)
    _, pc = pm.prefill(torch.from_numpy(toks[:, :S - 3]), S)
    got_c = reference_cache(pm, pc["layers"])
    assert [str(a.dtype) for a in jax.tree.leaves(got_c)] == \
        [str(np.asarray(a).dtype) for a in jax.tree.leaves(rc["layers"])]
