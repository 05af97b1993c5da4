"""The port's distributed MTTKRP and CP-ALS on 4 logical CPU devices,
against the reference on 4 JAX CPU devices.

One subprocess (module-scoped; ``XLA_FLAGS`` forces 4 host devices, which
the main test process must not set) runs the reference's
``make_mttkrp_fn`` on every mode of a 3-mode and a 4-mode zipf tensor
(``amped_cdf`` at r = 1, 2, 4 and ``equal_nnz``), and ``api.compile(plan,
cfg).run(10)`` for the ``paper`` preset (r = 2, so the merge runs) and the
``sorted`` preset with each exchange schedule. The port runs the same
tensors and seeds on ``cp_mesh(4, r, devices=["cpu"] * 4)``.

Tolerances: per-mode MTTKRP bitwise with the slot-order ``ref`` EC, fp32
and bf16 wire, and to 2e-4 with the one-hot kernels (as
tests/test_torch_als.py holds one device); fits to 1e-4 over 10 sweeps.
A bf16-wire run is held within the reference's own 0.08 of fp32
(tests/test_exchange.py) and to 5e-3 of the reference's bf16 run: the two
packages' eigh and matmul differ in the last bits, and on a bf16 wire such
a difference flips a bf16 rounding now and then and grows along the run
(one ulp of one entry of the starting factors moves this run's fits by
more than 1e-3 over 10 sweeps, where an fp32 wire moves them by under
1e-5: ``test_bf16_wire_grows_a_last_bit_difference``).
Inside the port: the fp32 gather variants give bitwise-equal factors, the
replicas stay bitwise identical after every sweep, and the ``sorted``
kernel's plain version equals ``ref`` bitwise at 4 devices on runs of at
most ``CHUNK_BLOCKS`` blocks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro_torch.api as tapi  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.core import mttkrp as t_dm  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.core.partition import build_plan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import decompose as launcher  # noqa: E402

R = 8
CASES = {"cdf_r1": ("amped_cdf", 1), "cdf_r2": ("amped_cdf", 2),
         "cdf_r4": ("amped_cdf", 4), "equal_nnz": ("equal_nnz", None)}
EXCHANGES = {"allgather": {"exchange.variant": "allgather"},
             "ring": {"exchange.variant": "ring"},
             "overlap4": {"exchange.variant": "overlap",
                          "exchange.chunk_rows": 4},
             "overlap_bf16": {"exchange.variant": "overlap",
                              "exchange.wire_dtype": "bfloat16"}}
PRESETS = {"paper": {"partition.replication": 2},
           "sorted": {"kernel.autotune": False}}
WIRES = ("float32", "bfloat16")


def _tensors(random_sparse):
    return {"3mode": random_sparse((40, 30, 20), 1500, seed=7,
                                   distribution="zipf"),
            "4mode": random_sparse((20, 15, 12, 10), 800, seed=8,
                                   distribution="zipf")}


SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
import repro.api as api
from repro.core.coo import random_sparse
from repro.core.partition import build_plan
from repro.core import mttkrp as M
from repro import comm

assert jax.device_count() == 4, jax.device_count()
R, CASES, EXCHANGES, PRESETS, WIRES = {consts}
{tensors_src}
out = {{}}
for tname, t in _tensors(random_sparse).items():
    rng = np.random.default_rng(0)
    glob = [rng.normal(size=(s, R)).astype(np.float32) for s in t.shape]
    for cname, (strategy, repl) in CASES.items():
        plan = build_plan(t, 4, strategy=strategy, replication=repl)
        factors = []
        for w in range(t.nmodes):
            f = np.zeros((plan.modes[w].padded_rows, R), np.float32)
            f[plan.global_to_padded[w]] = glob[w]
            factors.append(jnp.asarray(f))
        for mode in range(t.nmodes):
            part = plan.modes[mode]
            mesh = M.cp_mesh(4, part.r)
            dev = M.shard_plan_mode(part, mesh)
            for wire in WIRES:
                spec = comm.ExchangeSpec(variant="overlap", merge="ring_rs",
                                         wire_dtype=wire)
                fn = jax.jit(M.make_mttkrp_fn(part, mesh, use_kernel=False,
                                              exchange_spec=spec))
                out[f"mttkrp_{{tname}}_{{cname}}_{{mode}}_{{wire}}"] = \
                    np.asarray(fn(dev, factors))[plan.global_to_padded[mode]]
t = _tensors(random_sparse)["3mode"]
for preset, extra in PRESETS.items():
    base = api.preset(preset, {{"rank": R, "runtime.tol": 0.0,
                               "runtime.num_devices": 4, **extra}})
    plan = api.plan(t, base)
    out[f"r_{{preset}}"] = np.asarray(plan.modes[0].r)
    for ename, ov in EXCHANGES.items():
        with api.compile(plan, base.with_overrides(ov)) as solver:
            if preset == "paper" and ename == "allgather":
                r3 = solver.run(3)
                for w, f in enumerate(r3.factors):
                    out[f"load_factor_{{w}}"] = np.asarray(f)
                out["load_lam"] = np.asarray(r3.lam)
                out["load_fits"] = np.asarray(r3.fits)
                r4 = solver.run(4)
                for w, f in enumerate(r4.factors):
                    out[f"load4_factor_{{w}}"] = np.asarray(f)
                out["load4_fits"] = np.asarray(r4.fits)
            res = solver.run(10)
        out[f"fits_{{preset}}_{{ename}}"] = np.asarray(res.fits)
np.savez(sys.argv[1], **out)
print("done")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    import inspect
    src = SCRIPT.format(consts=repr((R, CASES, EXCHANGES, PRESETS,
                                             WIRES)),
                        tensors_src=inspect.getsource(_tensors))
    path = tmp_path_factory.mktemp("jax_multidevice") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, "-c", src, str(path)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


def _cpu_mesh(r):
    return t_dm.cp_mesh(4, r, devices=["cpu"] * 4)


def _padded(plan, glob, devices):
    out = []
    for w, g in enumerate(glob):
        f = np.zeros((plan.modes[w].padded_rows, g.shape[1]), np.float32)
        f[plan.global_to_padded[w]] = g
        out.append([torch.from_numpy(f).to(d, copy=True) for d in devices])
    return out


def _assert_replicas_equal(reps):
    for k in range(1, len(reps)):
        assert torch.equal(reps[0], reps[k]), k


@pytest.mark.parametrize("variant", ["ref", "blocked", "fused"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tname", ["3mode", "4mode"])
def test_mttkrp_matches_reference(jax_out, tname, case, variant):
    """Every mode's distributed MTTKRP (EC, ``ring_rs`` merge, overlap
    gather) to 2e-4 of the reference's, fp32 and bf16 wire, the same bits
    on every replica. With the slot-order ``ref`` EC both packages add the
    same products in the same order and the merge takes the same hops, so
    there the outputs are bitwise equal, bf16 wire included."""
    t = _tensors(random_sparse)[tname]
    strategy, repl = CASES[case]
    plan = build_plan(t, 4, strategy=strategy, replication=repl)
    mesh = _cpu_mesh(plan.modes[0].r)
    if case == "equal_nnz":
        assert mesh.r == 4  # the policy replicates every row 4 ways
    rng = np.random.default_rng(0)
    glob = [rng.normal(size=(s, R)).astype(np.float32) for s in t.shape]
    factors = _padded(plan, glob, mesh.devices)
    for mode in range(t.nmodes):
        part = plan.modes[mode]
        dev = t_dm.shard_plan_mode(part, mesh)
        for wire in WIRES:
            spec = comm.ExchangeSpec(variant="overlap", merge="ring_rs",
                                     wire_dtype=wire)
            out = t_dm.distributed_mttkrp(
                plan, mode, mesh, dev, factors, variant=variant,
                use_kernel=variant != "ref", exchange_spec=spec)
            _assert_replicas_equal(out)
            got = out[0].numpy()[plan.global_to_padded[mode]]
            want = jax_out[f"mttkrp_{tname}_{case}_{mode}_{wire}"]
            if variant == "ref":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _cfg(preset, exchange):
    return tapi.preset(preset, {"rank": R, "runtime.tol": 0.0,
                                "runtime.num_devices": 4, **PRESETS[preset],
                                **EXCHANGES[exchange]})


def _run(preset, exchange, sweeps=10):
    """The port's run, sweep by sweep, checking after each that every
    replica of every factor, gram, lam and fit holds the same bits."""
    t = _tensors(random_sparse)["3mode"]
    cfg = _cfg(preset, exchange)
    solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
    for _ in range(sweeps):
        s = solver.sweep()
        for reps in s.factors + s.grams + [s.lam, s.replica_fits]:
            assert len(reps) == 4
            _assert_replicas_equal(reps)
    return solver


@pytest.mark.parametrize("exchange", list(EXCHANGES))
@pytest.mark.parametrize("preset", list(PRESETS))
def test_als_fits_match_reference(jax_out, preset, exchange):
    solver = _run(preset, exchange)
    assert solver.plan.modes[0].r == int(jax_out[f"r_{preset}"])
    fits = np.asarray(solver.result().fits)
    want = jax_out[f"fits_{preset}_{exchange}"]
    assert fits.shape == want.shape == (10,)
    assert (np.diff(fits) > -1e-4).all(), fits
    if exchange == "overlap_bf16":
        np.testing.assert_allclose(fits, want, atol=5e-3)
        fp32 = jax_out[f"fits_{preset}_allgather"]
        assert abs(fits[-1] - fp32[-1]) < 0.08
    else:
        np.testing.assert_allclose(fits, want, atol=1e-4)


@pytest.mark.parametrize("wire,bound", [("float32", 1e-5),
                                        ("bfloat16", None)])
def test_bf16_wire_grows_a_last_bit_difference(wire, bound):
    """Why a bf16-wire run is held to 5e-3 of the reference's: one ulp of
    one entry of the starting factors moves this run's 10-sweep fits by
    more than 1e-3 on a bf16 wire, and by under 1e-5 on an fp32 one."""
    t = _tensors(random_sparse)["3mode"]
    cfg = _cfg("paper", "overlap_bf16").with_overrides(
        {"exchange.wire_dtype": wire})
    plan = tapi.plan(t, cfg)
    fits = []
    for nudge in (False, True):
        solver = tapi.compile(plan, cfg, device="cpu")
        if nudge:
            s = solver.state
            i = int(plan.global_to_padded[1][3])
            for f in s.factors[1]:
                f[i, 0] = torch.nextafter(f[i, 0], torch.tensor(2.0))
            s.grams[1] = [f.T @ f for f in s.factors[1]]
        fits.append(np.asarray(solver.run(10).fits))
    moved = np.abs(fits[1] - fits[0]).max()
    if bound is None:
        assert moved > 1e-3, moved
    else:
        assert moved < bound, moved


@pytest.mark.parametrize("preset", list(PRESETS))
def test_fp32_gather_variants_give_the_same_factors(preset):
    base = _run(preset, "allgather", sweeps=4).result().factors
    t = _tensors(random_sparse)["3mode"]
    for ov in ({"exchange.variant": "ring"},
               {"exchange.variant": "overlap"},
               {"exchange.variant": "overlap", "exchange.chunk_rows": 4},
               {"exchange.variant": "overlap", "exchange.merge": "ring_rs"}):
        cfg = _cfg(preset, "allgather").with_overrides(ov)
        got = tapi.compile(tapi.plan(t, cfg), cfg,
                           device="cpu").run(4).factors
        for a, b in zip(base, got):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_sorted_plain_equals_ref_bitwise_at_4_devices(r):
    """The ``sorted`` EC's plain version equals the slot-order ``ref`` at 4
    devices bitwise, through the merge and the gather, on shards whose
    runs are at most CHUNK_BLOCKS blocks."""
    t = random_sparse((40, 30, 20), 1500, seed=7, distribution="zipf")
    plan = build_plan(t, 4, replication=r, layout="sorted", block_p=16)
    mesh = _cpu_mesh(r)
    rng = np.random.default_rng(3)
    glob = [rng.normal(size=(s, R)).astype(np.float32) for s in t.shape]
    factors = _padded(plan, glob, mesh.devices)
    for mode, part in enumerate(plan.modes):
        for b2t in part.block_to_tile:
            runs = np.diff(np.flatnonzero(np.r_[True, b2t[1:] != b2t[:-1],
                                                True]))
            assert runs.max() <= _build.CHUNK_BLOCKS
        dev = t_dm.shard_plan_mode(part, mesh)
        outs = [t_dm.distributed_mttkrp(plan, mode, mesh, dev, factors,
                                        variant=v) for v in ("ref", "sorted")]
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_load_state_carries_a_4_device_reference_result(jax_out):
    """A 4-device JAX CPResult goes onto every replica of the port's
    4-device solver; one more sweep lands within 1e-4 of the reference's."""
    t = _tensors(random_sparse)["3mode"]
    cfg = _cfg("paper", "allgather")
    solver = tapi.compile(tapi.plan(t, cfg), cfg, device="cpu")
    factors = [jax_out[f"load_factor_{w}"] for w in range(3)]
    solver.load_state(factors, jax_out["load_lam"],
                      fits=list(jax_out["load_fits"]), sweep=3)
    for reps in solver.state.factors + solver.state.grams + \
            [solver.state.lam]:
        _assert_replicas_equal(reps)
    np.testing.assert_array_equal(solver.result().factors[0], factors[0])
    solver.sweep()
    res = solver.result()
    assert res.sweeps == 4
    for w, f in enumerate(res.factors):
        np.testing.assert_allclose(f, jax_out[f"load4_factor_{w}"],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.fits, jax_out["load4_fits"], atol=1e-4)


def test_launcher_4_devices_on_cpu(capsys):
    launcher.main(["--profile", "twitch", "--scale", "2e-5", "--iters", "2",
                   "--device", "cpu", "--devices", "4", "--exchange-report"])
    out = capsys.readouterr().out
    assert "devices=4" in out
    assert "sweep 1: fit=" in out and "sweep 2: fit=" in out
    line = next(x for x in out.splitlines() if x.startswith("exchange "))
    modelled = int(line.split("modelled ")[1].split(" ")[0])
    counted = line.split("counted per device [")[1].split("]")[0]
    assert modelled > 0
    assert [int(x) for x in counted.split(",")] == [modelled] * 4


def _fake_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_cp_mesh_never_colocates_unasked(monkeypatch):
    """The default mesh puts logical device k on cuda:k and raises, naming
    how to share a card, when fewer cards are visible."""
    _fake_cards(monkeypatch, 1)
    with pytest.raises(RuntimeError, match=r"devices=\['cuda:0'\] \* 4"):
        t_dm.cp_mesh(4, 2)
    mesh = t_dm.cp_mesh(4, 2, devices=["cuda:0"] * 4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    assert mesh.shape == (2, 2)
    _fake_cards(monkeypatch, 4)
    assert [str(d) for d in t_dm.cp_mesh(4, 1).devices] == \
        ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    with pytest.raises(ValueError, match="divide"):
        t_dm.cp_mesh(4, 3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one kind"):
        t_dm.cp_mesh(2, 1, devices=["cpu", "cuda:0"])


def test_launcher_on_too_few_cards_raises_the_mesh_message(monkeypatch):
    _fake_cards(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="place several logical devices"):
        launcher.main(["--profile", "twitch", "--scale", "2e-5",
                       "--iters", "1", "--devices", "4"])


def test_compile_checks_the_mesh_against_the_plan():
    t = _tensors(random_sparse)["3mode"]
    cfg = _cfg("paper", "ring")
    plan = tapi.plan(t, cfg)
    with pytest.raises(ValueError, match="grid"):
        tapi.compile(plan, cfg, mesh=_cpu_mesh(4))
    with pytest.raises(ValueError, match="not both"):
        tapi.compile(plan, cfg, mesh=_cpu_mesh(2), device="cpu")
    solver = tapi.compile(plan, cfg, mesh=_cpu_mesh(2))
    assert solver.mesh.shape == (2, 2)
    assert solver.exchange_spec.variant == "ring"
