"""The port's LM serving functions (``repro_torch.models.lm_serve``) against
the reference's ``repro.models.lm_serve``.

Greedy tokens are held equal to the reference's on the reference's weights
wherever the reference's top-2 logit margin exceeds ``MARGIN`` at every
step so far: past a near-tie, rounding may pick the other token in either
package. Such a step is reported with a warning, not hidden. Sampled tokens
cannot match ``jax.random`` (the port samples with ``torch.multinomial``
from a caller's generator), so sampling is held to reproducibility only.
"""
import importlib
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import lm_serve as ref_lm_serve  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import lm_serve  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_cache)
from repro_torch.models.transformer import Model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-3
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these small models on one thread: the suite runs
    files in parallel workers, and timing-sensitive reference tests share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def extras(cfg, batch):
    rng = np.random.default_rng(0)
    if cfg.encoder is not None:
        a = {"frames": rng.normal(size=(batch, 12, cfg.d_model))}
    elif any(s.mixer == "cross_attn" for s in cfg.pattern):
        a = {"images": rng.normal(size=(batch, 10, cfg.d_model))}
    else:
        return None, None
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return ({k: jnp.asarray(v) for k, v in a.items()},
            {k: torch.from_numpy(v) for k, v in a.items()})


def ref_greedy(rm, params, prompt, steps, cache_len, extra):
    """The reference's greedy loop, step by step, with each step's top-2
    margin per row."""
    logits, cache = rm.prefill(params, prompt, cache_len, extra=extra)
    toks, margins = [], []
    for _ in range(steps):
        lg = np.asarray(logits[:, -1])
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1:], axis=-1)
        toks.append(np.asarray(tok))
        logits, cache = rm.decode_step(params, tok, cache)
    return np.concatenate(toks, axis=1), np.stack(margins, axis=1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_greedy_generate_matches_reference(arch):
    rcfg = ref_get_config(arch, "smoke")
    rm = RefModel(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    pm = load_reference_params(Model(get_config(arch, "smoke"), device="cpu"),
                               jax.tree.map(np.asarray, params))
    prompt = np.random.default_rng(2).integers(0, rcfg.vocab, (2, 8))
    rex, pex = extras(rcfg, 2)
    cache_len = 8 + STEPS
    want, margins = ref_greedy(rm, params, jnp.asarray(prompt), STEPS,
                               cache_len, rex)
    ref_out = np.asarray(ref_lm_serve.generate(
        rm, params, jnp.asarray(prompt), steps=STEPS, cache_len=cache_len,
        extra=rex))
    np.testing.assert_array_equal(ref_out, want)
    got = lm_serve.generate(pm, torch.from_numpy(prompt), steps=STEPS,
                            cache_len=cache_len, extra=pex).numpy()
    assert got.shape == want.shape and got.dtype == np.int64
    for b in range(want.shape[0]):
        close = np.flatnonzero(margins[b] <= MARGIN)
        k = int(close[0]) if close.size else STEPS
        if k < STEPS:
            warnings.warn(f"{arch} row {b}: top-2 margin "
                          f"{margins[b, k]:.2e} <= {MARGIN} at step {k}; "
                          f"compared {k} of {STEPS} tokens")
        np.testing.assert_array_equal(got[b, :k], want[b, :k])


def granite():
    cfg = get_config("granite_8b", "smoke")
    return cfg, Model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))


def test_generate_greedy_deterministic():
    cfg, m = granite()
    prompt = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    out1 = lm_serve.generate(m, prompt, steps=5, cache_len=16)
    out2 = lm_serve.generate(m, prompt, steps=5, cache_len=16)
    assert out1.shape == (2, 5)
    assert torch.equal(out1, out2)
    assert bool(((out1 >= 0) & (out1 < cfg.vocab)).all())


def test_generate_matches_forward_argmax():
    cfg, m = granite()
    prompt = torch.randint(0, cfg.vocab, (1, 8),
                           generator=torch.Generator().manual_seed(2))
    want = int(torch.argmax(m(prompt)[0, -1]))
    out = lm_serve.generate(m, prompt, steps=1, cache_len=12)
    assert int(out[0, 0]) == want


def test_sampled_generate_is_reproducible_from_a_seed():
    cfg, m = granite()
    prompt = torch.randint(0, cfg.vocab, (3, 6),
                           generator=torch.Generator().manual_seed(3))

    def run(seed):
        return lm_serve.generate(m, prompt, steps=8, cache_len=16,
                                 temperature=5.0,
                                 generator=torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(((a >= 0) & (a < cfg.vocab)).all())


def test_prefill_and_decode_step_wrappers():
    cfg, m = granite()
    prompt = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(4))
    lg, cache = lm_serve.make_prefill_step(m, 10)(prompt)
    lg2, cache2 = m.prefill(prompt, 10)
    assert torch.equal(lg, lg2) and cache["pos"] == 6
    tok = torch.argmax(lg[:, -1:], dim=-1)
    lg, cache = lm_serve.make_decode_step(m)(tok, cache)
    assert lg.shape == (2, 1, cfg.vocab) and cache["pos"] == 7


MESHES = {
    "1x1": None,  # a real jax Mesh for the reference, its duck for the port
    "2x16": types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 2, "model": 16}),
}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["granite_8b", "jamba15_large",
                                  "deepseek_v2_lite", "rwkv6_7b",
                                  "whisper_small"])
def test_cache_specs_match_reference(arch, mesh):
    """Each spec is the tuple of the reference's PartitionSpec, for every
    kv_layout, with and without seq_shard, at batch 1, 2 and 3."""
    ref_mesh = MESHES[mesh]
    port_mesh = ref_mesh
    if ref_mesh is None:
        ref_mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                        ("data", "model"))
        port_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                          shape={"data": 1, "model": 1})
    from jax.sharding import PartitionSpec as P
    rm = RefModel(ref_get_config(arch, "smoke"))
    pm = Model(get_config(arch, "smoke"), device="meta")
    for batch in (1, 2, 3):
        for kv_layout in ("auto", "replicated_heads"):
            for seq_shard in (False, True):
                kw = dict(batch=batch, kv_layout=kv_layout,
                          seq_shard=seq_shard)
                want = jax.tree.map(
                    tuple, ref_lm_serve.cache_specs(rm, ref_mesh, **kw),
                    is_leaf=lambda x: isinstance(x, P))
                got = lm_serve.cache_specs(pm, port_mesh, **kw)
                assert got == want, (kw, got, want)


def test_cache_layout_maps_to_reference_empty_cache():
    """The port's per-layer cache, mapped by reference_cache, has the
    reference's tree, shapes and dtypes (empty cache and prefill cache)."""
    for arch in ("jamba15_large", "deepseek_v2_lite", "rwkv6_7b",
                 "whisper_small", "gemma3_1b"):
        rm = RefModel(ref_get_config(arch, "smoke"))
        pm = Model(get_config(arch, "smoke"), device="cpu")
        want = rm.empty_cache(2, 8)
        got = reference_cache(pm, pm.empty_cache(2, 8))
        assert jax.tree.structure(got) == jax.tree.structure(want), arch
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
            assert not g.any()


def test_serving_shim_warns_and_reexports():
    sys.modules.pop("repro_torch.serving.serve", None)
    with pytest.warns(DeprecationWarning, match="lm_serve"):
        mod = importlib.import_module("repro_torch.serving.serve")
    for name in ("make_prefill_step", "make_decode_step", "cache_specs",
                 "generate"):
        assert getattr(mod, name) is getattr(lm_serve, name)


def test_serve_lm_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--device",
         "cpu", "--gen", "4"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "deepseek-v2-lite-smoke on cpu: generated 16 tokens" in out.stdout
    assert "sample token ids:" in out.stdout
