"""One train step of every ``ARCH_IDS`` smoke config, in the reference and
in the port, on the reference's weights (shared by
tests/test_torch_training.py and tests/test_torch_train_archs.py, which
split the archs between them so that xdist spreads the JAX compiles).

The reference initialises each model (``Model.init(PRNGKey(0))``),
``models.convert`` carries its weights into the port, and the same numpy
batch (tokens from seed 1, targets rolled by one, the reference test's
``frames`` / ``images``) goes through the reference's jitted
``make_train_step`` and the port's, with ``AdamWConfig(lr=1e-3, warmup=1,
total_steps=10)`` as in tests/test_archs_smoke.py. Compared per leaf as
``max|port - ref| / max(1, max|ref|)`` in float32 on the CPU: the loss,
``grad_norm``, every updated parameter, ``mu``, ``nu``; ``lr`` and
``step`` too.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.transformer import Model as RefModel  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro.training.train_step import make_train_step as ref_make  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import (load_reference_params,  # noqa: E402
                                        reference_opt_state, reference_params)
from repro_torch.models.transformer import REMATS, Model  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

B, S = 2, 16
TOL = 1e-4
# rwkv6's r/k-path gradients are ill-conditioned at smoke size (8-wide
# heads under a group norm with eps 1e-5): the reference's own float32
# gradients of wk, wr, u, mu_k, mu_r differ from its float64 evaluation
# (jax_enable_x64) by 3.8-4.2e-4 relative, and the port's by 2.0-2.2e-4.
# So its grad_norm (measured 1.1e-4 from the reference) and its first
# Adam update (1.5e-4: g/(|g|+eps) of a near-zero gradient) are held to
# this bound; its loss and moments stay at TOL.
RWKV_GRAD_TOL = 5e-4


def batch_for(cfg) -> dict:
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    rng = np.random.default_rng(0)
    if cfg.encoder is not None:
        batch["frames"] = rng.normal(size=(B, 12, cfg.d_model)).astype(
            np.float32)
    elif any(s.mixer == "cross_attn" for s in cfg.pattern):
        batch["images"] = rng.normal(size=(B, 10, cfg.d_model)).astype(
            np.float32)
    return batch


OPT = dict(lr=1e-3, warmup=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def reference_step(arch: str):
    """(initial weights, new params, new opt, metrics) of the reference, as
    numpy pytrees."""
    cfg = ref_get_config(arch, "smoke")
    model = RefModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    step = jax.jit(ref_make(model, ref_opt.AdamWConfig(**OPT)))
    batch = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
    new_p, new_o, m = step(params, ref_opt.adamw_init(params), batch)
    host = functools.partial(jax.tree.map, np.asarray)
    return host(params), host(new_p), host(new_o), host(m)


@functools.lru_cache(maxsize=None)
def port_step(arch: str, remat: str):
    """The port's step from the reference's weights, as reference-layout
    numpy pytrees: (new params, new opt, metrics)."""
    tree, _, _, _ = reference_step(arch)
    cfg = dataclasses.replace(get_config(arch, "smoke"), remat=remat)
    model = load_reference_params(Model(cfg, device="cpu"), tree)
    step = make_train_step(model, opt_mod.AdamWConfig(**OPT))
    opt = opt_mod.adamw_init(dict(model.named_parameters()))
    opt, m = step(opt, batch_for(cfg))
    return (reference_params(model), reference_opt_state(model, opt),
            {k: v.numpy() for k, v in m.items()})


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def check_train_step(arch: str, remat: str) -> None:
    """The port's step against the reference's within TOL (rwkv6:
    RWKV_GRAD_TOL for grad_norm and the parameters); remat ``full`` and
    ``dots`` bitwise the port's ``none``."""
    assert remat in REMATS
    _, rp, ro, rm = reference_step(arch)
    pp, po, pm = port_step(arch, remat)
    grad_tol = RWKV_GRAD_TOL if arch == "rwkv6_7b" else TOL
    assert rel(pm["loss"], rm["loss"]) < TOL
    assert rel(pm["grad_norm"], rm["grad_norm"]) < grad_tol
    assert rel(pm["lr"], rm["lr"]) < 1e-6
    assert int(po["step"]) == int(ro["step"]) == 1
    for name, got, want, tol in (("params", pp, rp, grad_tol),
                                 ("mu", po["mu"], ro["mu"], TOL),
                                 ("nu", po["nu"], ro["nu"], TOL)):
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(got)):
            assert g.shape == w.shape and g.dtype == w.dtype, (name, path)
            assert rel(g, w) < tol, (name, jax.tree_util.keystr(path),
                                     rel(g, w))
    if remat != "none":
        np_, no_, nm_ = port_step(arch, "none")
        for a, b in zip(jax.tree.leaves((pp, po, pm)),
                        jax.tree.leaves((np_, no_, nm_))):
            np.testing.assert_array_equal(a, b)
