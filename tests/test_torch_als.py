"""The port's one-device MTTKRP, CP-ALS, solver and launcher on the CPU,
against the reference package on the same seeds.

Tolerances: the MTTKRP's ``ref`` and ``sorted`` variants are bitwise (both
packages add the same f32 products in slot order); the one-hot variants
are held to 2e-4 as the reference holds its own. ALS fits are held to 1e-4
over 10 sweeps and factors after a carried-over sweep to 1e-4: the two
packages' eigh, matmul and norm come from different libraries and round
differently in the last bits.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro.core import mttkrp as j_dm  # noqa: E402
from repro.core.coo import from_dense, random_sparse  # noqa: E402
from repro.core.partition import build_plan as j_build_plan  # noqa: E402
from repro_torch.core import mttkrp as t_dm  # noqa: E402
from repro_torch.core.coo import SparseTensor, to_dense  # noqa: E402
from repro_torch.core.partition import build_plan as t_build_plan  # noqa: E402
from repro_torch.kernels.ref import mttkrp_dense_ref  # noqa: E402
from repro_torch.launch import decompose as launcher  # noqa: E402

PRESETS = ["paper", "optimized", "fused", "sorted"]


def _port_tensor(t):
    return SparseTensor(t.indices, t.values, t.shape)


def _padded_factors(plan, t, rank, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(t.nmodes):
        f = np.zeros((plan.modes[w].padded_rows, rank), np.float32)
        f[plan.global_to_padded[w]] = rng.normal(
            size=(t.shape[w], rank)).astype(np.float32)
        out.append(f)
    return out


def _mttkrp_both(t, factors, use_kernel):
    """(reference, port) one-device MTTKRP of every mode, blocked layout."""
    jplan = j_build_plan(t, 1)
    tplan = t_build_plan(_port_tensor(t), 1)
    mesh = j_dm.cp_mesh(1, 1)
    out = []
    for mode in range(t.nmodes):
        j = j_dm.distributed_mttkrp(
            jplan, mode, mesh, j_dm.shard_plan_mode(jplan.modes[mode], mesh),
            [jnp.asarray(f) for f in factors], use_kernel=use_kernel,
            ring=False)
        tmesh = t_dm.cp_mesh(1, 1, devices=["cpu"])
        p = t_dm.distributed_mttkrp(
            tplan, mode, tmesh, t_dm.shard_plan_mode(tplan.modes[mode], tmesh),
            [[torch.from_numpy(f)] for f in factors], use_kernel=use_kernel)
        out.append((np.asarray(j), p[0].numpy()))
    return out, tplan


def _assert_matches(pairs, use_kernel):
    for j, p in pairs:
        if use_kernel:  # blocked: the reference's one-hot product
            np.testing.assert_allclose(p, j, rtol=2e-4, atol=2e-4)
        else:           # ref: the same sums in the same order
            np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_one_device_mttkrp_matches_reference(small_tensor, monkeypatch,
                                              use_kernel):
    """Modes 0-2 (the counterpart of test_mttkrp_als.py:26), against the
    reference and the dense oracle."""
    monkeypatch.delenv("AMPED_EC_VARIANT", raising=False)
    t = small_tensor
    plan = t_build_plan(_port_tensor(t), 1)
    factors = _padded_factors(plan, t, 16)
    pairs, tplan = _mttkrp_both(t, factors, use_kernel)
    _assert_matches(pairs, use_kernel)
    g2p = tplan.global_to_padded
    f_glob = [torch.from_numpy(f[g2p[w]]) for w, f in enumerate(factors)]
    dense_t = torch.from_numpy(to_dense(_port_tensor(t)))
    for mode, (_, p) in enumerate(pairs):
        dense = mttkrp_dense_ref(dense_t, f_glob, mode)
        np.testing.assert_allclose(p[g2p[mode]], dense.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_one_device_mttkrp_4mode(small_tensor_4mode, monkeypatch):
    monkeypatch.delenv("AMPED_EC_VARIANT", raising=False)
    t = small_tensor_4mode
    plan = t_build_plan(_port_tensor(t), 1)
    pairs, _ = _mttkrp_both(t, _padded_factors(plan, t, 8), True)
    _assert_matches(pairs, True)


def _cfgs(api, name, **extra):
    return api.preset(name, {"rank": 8, "runtime.tol": 0.0,
                             "kernel.autotune": False,
                             "runtime.num_devices": 1, **extra})


@pytest.mark.parametrize("preset", PRESETS)
def test_als_fits_match_reference(small_tensor, preset):
    t = small_tensor
    jcfg, tcfg = _cfgs(japi, preset), _cfgs(tapi, preset)
    jres = japi.compile(japi.plan(t, jcfg), jcfg).run(10)
    tres = tapi.compile(tapi.plan(_port_tensor(t), tcfg), tcfg,
                        device="cpu").run(10)
    assert len(tres.fits) == 10
    np.testing.assert_allclose(tres.fits, jres.fits, atol=1e-4)
    assert (np.diff(tres.fits) > -1e-4).all(), tres.fits


def test_sorted_als_bitwise_equals_ref():
    """The 'sorted' preset's ALS produces the same factors bitwise as the
    plain reference EC on the same row-sorted plan (the counterpart of
    test_sorted_kernel.py:270)."""
    t = _port_tensor(random_sparse((16, 12, 10), 300, seed=2,
                                   distribution="zipf"))
    base = tapi.preset("paper", {"rank": 4, "runtime.tol": 0.0,
                                 "partition.layout": "sorted",
                                 "partition.replication": 1})
    srt = base.with_overrides({"kernel.use_kernel": True,
                               "kernel.variant": "sorted",
                               "kernel.autotune": False})
    outs = {}
    for name, cfg in (("ref", base), ("sorted", srt)):
        solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
        outs[name] = solver.run(2).factors
    for a, b in zip(outs["ref"], outs["sorted"]):
        np.testing.assert_array_equal(a, b)


def test_load_state_carries_a_reference_result(small_tensor):
    """A JAX CPResult's factors and lam go straight into the port's solver;
    one more sweep in each package lands within 1e-4."""
    t = small_tensor
    jcfg, tcfg = _cfgs(japi, "paper"), _cfgs(tapi, "paper")
    jsolver = japi.compile(japi.plan(t, jcfg), jcfg)
    jres = jsolver.run(3)
    tsolver = tapi.compile(tapi.plan(_port_tensor(t), tcfg), tcfg,
                           device="cpu")
    tsolver.load_state(jres.factors, jres.lam, fits=jres.fits,
                       sweep=jres.sweeps)
    np.testing.assert_array_equal(tsolver.result().factors[0],
                                  jres.factors[0])
    jsolver.sweep()
    tsolver.sweep()
    jr, tr = jsolver.result(), tsolver.result()
    assert tr.sweeps == jr.sweeps == 4
    for a, b in zip(tr.factors, jr.factors):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr.fits, jr.fits, atol=1e-4)


def test_load_state_rejects_mismatched_payload(small_tensor):
    cfg = _cfgs(tapi, "paper")
    solver = tapi.compile(tapi.plan(_port_tensor(small_tensor), cfg), cfg,
                          device="cpu")
    f = solver.result().factors
    with pytest.raises(ValueError, match="rank"):
        solver.load_state([x[:, :4] for x in f], np.ones(4))
    with pytest.raises(ValueError, match="rows"):
        solver.load_state([f[0][:-1]] + f[1:], np.ones(8))


def test_sweep_is_async_and_updates_in_place(small_tensor):
    cfg = _cfgs(tapi, "sorted")
    solver = tapi.compile(tapi.plan(_port_tensor(small_tensor), cfg), cfg,
                          device="cpu")
    before = [f[0].data_ptr() for f in solver.state.factors]
    state = solver.sweep()
    assert isinstance(state.fits[-1], torch.Tensor)
    assert state.fits[-1].dim() == 0
    assert [f[0].data_ptr() for f in state.factors] == before


def test_exact_recovery():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.2, 1, (20, 3))
    b = rng.uniform(0.2, 1, (15, 3))
    c = rng.uniform(0.2, 1, (10, 3))
    t = _port_tensor(from_dense(
        np.einsum("ir,jr,kr->ijk", a, b, c).astype(np.float32)))
    cfg = tapi.preset("paper", {"rank": 3, "runtime.tol": 1e-9})
    res = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu").run(40)
    assert res.fits[-1] > 0.99, res.fits[-1]
    recon = res.reconstruct_at(t.indices)
    assert np.abs(recon - t.values).max() / np.abs(t.values).max() < 0.1


def test_config_round_trips_between_packages():
    for name in PRESETS:
        jcfg = japi.preset(name, {"kernel.variant": "fused",
                                  "exchange.variant": "overlap"})
        tcfg = tapi.DecomposeConfig.from_json(jcfg.to_json())
        assert tcfg.to_dict() == jcfg.to_dict()
        assert tapi.preset(name).to_dict() == japi.preset(name).to_dict()
        back = japi.DecomposeConfig.from_json(tcfg.to_json())
        assert back == jcfg
    with pytest.raises(ValueError):
        tapi.preset("paper", {"exchange.variant": "nope"})


@pytest.mark.parametrize("overrides,item", [
    ({"exchange.variant": "overlap", "exchange.autotune_chunk": True},
     "Autotuner"),
    ({"kernel.autotune": True, "kernel.use_kernel": True}, "Autotuner"),
])
def test_plan_rejects_unported(small_tensor, overrides, item, monkeypatch):
    """Both autotuners are ported (they used to raise here): with the EC
    tuners of both packages patched to one winner, the plan is the
    reference's, bitwise, and the compiled spec resolves the chunk size and
    the ring depth as the reference resolves them (on one device the chunk
    tuner returns the default chunking untimed)."""
    from repro.comm import resolve_exchange_spec as j_resolve
    from repro.kernels import autotune as j_at
    from repro_torch.kernels import autotune as t_at
    assert item == "Autotuner"
    monkeypatch.setattr(j_at, "autotune_ec",
                        lambda *a, **k: j_at.ECConfig(16, 64, 3))
    monkeypatch.setattr(t_at, "autotune_ec",
                        lambda *a, **k: t_at.ECConfig(16, 64, 3))
    jcfg = japi.preset("paper", {"rank": 8, **overrides})
    tcfg = tapi.preset("paper", {"rank": 8, **overrides})
    jplan = japi.plan(small_tensor, jcfg)
    tplan = tapi.plan(_port_tensor(small_tensor), tcfg, device="cpu")
    for jm, tm in zip(jplan.modes, tplan.modes, strict=True):
        assert (tm.tile, tm.block_p) == (jm.tile, jm.block_p)
        for f in ("indices", "values", "local_rows", "block_to_tile"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    solver = tapi.compile(tplan, tcfg, device="cpu")
    jspec = j_resolve(jcfg.exchange, plan=jplan, rank=8,
                      mesh=j_dm.cp_mesh(1, 1))
    assert solver.exchange_spec.chunk_rows == jspec.chunk_rows
    assert solver.exchange_spec.variant == jspec.variant
    assert solver._kernel_kw == jcfg.kernel.mttkrp_kwargs(nmodes=3, rank=8)


@pytest.mark.parametrize("overrides,item", [
    ({"schedule.rebalance": "on", "runtime.memory_budget": 1 << 20},
     "Rebalancer"),
    ({"runtime.streaming": True}, "Streaming"),
    ({"runtime.checkpoint_dir": "x"}, "checkpoint"),
    ({"runtime.trace": True}, "tracing"),
])
def test_compile_rejects_unported(small_tensor, overrides, item):
    """Checkpointing and tracing still raise. The rebalancer under a memory
    budget is ported: its member caps are the reference's. Streaming an
    in-memory plan is refused by both packages alike (it needs a tensor
    store plan)."""
    plan = tapi.plan(_port_tensor(small_tensor), tapi.preset("paper"))
    cfg = tapi.preset("paper", overrides)
    if item in ("checkpoint", "tracing"):
        with pytest.raises(NotImplementedError, match=item):
            tapi.compile(plan, cfg, device="cpu")
        return
    jcfg = japi.preset("paper", overrides)
    jplan = japi.plan(small_tensor, jcfg)
    if item == "Streaming":
        for compile_, p, c in ((japi.compile, jplan, jcfg),
                               (lambda p, c: tapi.compile(p, c,
                                                          device="cpu"),
                                plan, cfg)):
            with pytest.raises(ValueError, match="out-of-core plan"):
                compile_(p, c)
        return
    caps = tapi.compile(plan, cfg, device="cpu").rebalancer.member_nnz_caps
    want = japi.compile(jplan, jcfg).rebalancer.member_nnz_caps
    assert caps == want and len(caps) == 3


def test_compile_defaults_to_the_card(small_tensor, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tapi.preset("paper")
    plan = tapi.plan(_port_tensor(small_tensor), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.compile(plan, cfg)
    from repro_torch.core import als
    with pytest.raises(TypeError, match="device"):  # no silent CPU default
        als.init_factors(plan, cfg.rank, seed=0)


def test_launcher_on_cpu(capsys):
    launcher.main(["--preset", "sorted", "--set", "kernel.autotune=false",
                   "--profile", "twitch", "--scale", "2e-5", "--iters", "2",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "geometry: tile=8 block_p=128 layout=sorted" in out
    assert "sweep 1: fit=" in out and "sweep 2: fit=" in out
    assert "plan " in out and "| compile " in out and "| execute " in out


def test_launcher_has_no_unported_flags(tmp_path):
    for argv in (["--plan-cache", "x"], ["--ckpt", "x"]):
        with pytest.raises(SystemExit):
            launcher.main(argv)
    # --store is ported: the flag parses, and a directory that is no store
    # is refused by the store itself
    from repro_torch.store import StoreFormatError
    with pytest.raises(StoreFormatError, match="not a tensor store"):
        launcher.main(["--store", str(tmp_path), "--device", "cpu"])
