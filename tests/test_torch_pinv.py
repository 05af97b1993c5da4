"""The ALS solve's pseudo-inverse on the CPU: which version runs, and what
the CPU's keeps.

``core/als._pinv_psd`` takes the CUDA kernel (``kernels/pinv.pinv_psd``)
for card tensors, at every rank up to ``pinv.MAX_RANK`` (the EC kernels'
128), and ``pinv_psd_plain`` (the ``eigh`` code the solve ran before the
kernel) for CPU tensors; a card configuration the kernel does not take is
refused. Held here: on the CPU ``_pinv_psd`` gives that code's bits; a
sweep counts one ``als.pinv.plain`` for each mode and replica and no
``als.pinv.kernel``; the rule as a pure function; the solver refusing a
card configuration outside it; and the kernel's wrapper refusing what it
does not take before any launch. The kernel itself is held on the card by
``tests/test_torch_pinv_cuda.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import als  # noqa: E402
from repro_torch.api.solver import CPSolver  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.core.mttkrp import cp_mesh  # noqa: E402
from repro_torch.kernels import _build, pinv  # noqa: E402

CPU = torch.device("cpu")


def _eigh_pinv(grams, rcond=1e-8):
    """The solve's pseudo-inverse as it was written before the kernel."""
    v = functools.reduce(lambda a, b: a * b, grams)
    w, u = torch.linalg.eigh(v)
    w_inv = torch.where(w > rcond * w.abs().max(), 1.0 / w,
                        torch.zeros_like(w))
    return (u * w_inv[None, :]) @ u.T


def _grams(kind, rank, ngrams, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "factors":   # the solver's input: grams of uniform factors
        out = []
        for _ in range(ngrams):
            f = rng.uniform(0.1, 1.0, size=(3 * rank + 5, rank))
            out.append(torch.from_numpy(f.astype(np.float32)))
        return [f.T @ f for f in out]
    if kind == "rank_deficient":
        b = rng.integers(-3, 4, size=(rank, rank // 2)).astype(np.float32)
        return [torch.from_numpy(b @ b.T)] * ngrams
    assert kind == "zero"
    return [torch.zeros((rank, rank))] * ngrams


@pytest.mark.parametrize("kind", ["factors", "rank_deficient", "zero"])
@pytest.mark.parametrize("rank,ngrams", [(1, 1), (3, 2), (8, 2), (32, 2),
                                         (32, 4), (65, 2), (128, 3),
                                         (129, 2)])
def test_pinv_psd_on_cpu_gives_the_eigh_bits(kind, rank, ngrams):
    grams = _grams(kind, rank, ngrams)
    got = als._pinv_psd(grams)
    want = _eigh_pinv(grams)
    assert got.dtype == torch.float32 and got.shape == (rank, rank)
    assert torch.equal(got, want)


def _counts():
    reg = obs.get_registry()
    return (reg.counter("als.pinv.plain"), reg.counter("als.pinv.kernel"))


@pytest.mark.parametrize("devices", [1, 4])
def test_sweep_counts_one_plain_pinv_a_mode_and_replica(devices):
    t = random_sparse((24, 18, 12), 400, seed=3, distribution="zipf")
    cfg = api.preset("sorted", {"rank": 8, "kernel.autotune": False,
                                "runtime.tol": 0.0,
                                "runtime.num_devices": devices})
    plan = api.plan(t, cfg, device=CPU)
    mesh = cp_mesh(devices, plan.modes[0].r, devices=[CPU] * devices)
    launched = _build.LAUNCHES["pinv_psd"]
    with api.compile(plan, cfg, mesh=mesh) as solver:
        plain, kernel = _counts()
        solver.run(2)
        assert _counts() == (plain + 2 * plan.nmodes * devices, kernel)
    assert _build.LAUNCHES["pinv_psd"] == launched


@pytest.mark.parametrize("rank", [8, 65])
def test_nothing_is_begun_on_the_cpu(rank):
    """On the CPU a replica's solve starts nothing on a card and launches
    nothing: it pseudo-inverts in line with ``eigh``, once, with the bits
    of the solve as it was written before the kernel."""
    grams = [_grams("factors", rank, 3)[w] for w in range(3)]
    m = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, size=(40, rank)).astype(np.float32))
    plain = obs.get_registry().counter("als.pinv.plain")
    launched = dict(_build.LAUNCHES)
    f_new, gram, lam = als._solve(m, torch.empty_like(m), grams, 0)
    assert obs.get_registry().counter("als.pinv.plain") == plain + 1
    assert _build.LAUNCHES == launched
    want = m @ _eigh_pinv(grams[1:])
    norms = torch.linalg.vector_norm(want, dim=0)
    assert torch.equal(lam, torch.where(norms > 0, norms,
                                        torch.ones_like(norms)))
    assert torch.equal(f_new, want / lam[None, :])
    assert torch.equal(gram, f_new.T @ f_new)


@pytest.mark.parametrize("device,rank,ngrams,want", [
    ("cuda", 1, 2, True), ("cuda", 32, 2, True), ("cuda", 64, 4, True),
    ("cuda:1", 16, 1, True), ("cuda", 64, pinv.MAX_GRAMS, True),
    ("cuda", 65, 2, True), ("cuda", 128, 2, True),
    ("cuda", 129, 2, "R in"), ("cuda", 0, 2, "R in"),
    ("cuda", 32, 0, "grams"), ("cuda", 32, pinv.MAX_GRAMS + 1, "grams"),
    ("cpu", 1, 2, False), ("cpu", 32, 2, False), ("cpu", 200, 12, False),
    ("meta", 32, 2, False)])
def test_takes_kernel_rule(device, rank, ngrams, want):
    """A card always takes the kernel, and refuses a shape the kernel does
    not take (it has no other version); nothing else ever takes it."""
    assert pinv.MAX_RANK == _build.MAX_ITEM_RANK == 128
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            pinv.takes_kernel(torch.device(device), rank, ngrams)
    else:
        assert pinv.takes_kernel(torch.device(device), rank, ngrams) is want


class _CardMesh:
    """A mesh's devices alone: the solver's refusal reads nothing else."""
    devices = [torch.device("cuda:0")]


@pytest.mark.parametrize("shape,rank,match", [
    ((12, 10, 8), 129, "R in"), ((4,) * 10, 8, "grams")])
def test_solver_refuses_a_card_configuration_the_kernel_does_not_take(
        shape, rank, match):
    """At ``api.compile`` (``CPSolver``), before anything is placed: a rank
    above 128, or more than 9 modes, on a card."""
    t = random_sparse(shape, 60, seed=1)
    cfg = api.preset("sorted", {"rank": rank, "kernel.autotune": False,
                                "runtime.num_devices": 1})
    plan = api.plan(t, cfg, device=CPU)
    launched = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        CPSolver(plan, cfg, _CardMesh())
    assert _build.LAUNCHES == launched


def _refusals():
    g = torch.ones((8, 8))
    return {
        "no grams": ([], ValueError, "1 to"),
        "too many grams": ([g] * (pinv.MAX_GRAMS + 1), ValueError, "1 to"),
        "not a tensor": ([np.ones((8, 8), np.float32)], TypeError,
                         "torch.Tensor"),
        "not square": ([torch.ones((8, 4))], ValueError, "expected"),
        "a vector": ([torch.ones(8)], ValueError, "expected"),
        "rank over the limit": ([torch.ones((129, 129))] * 2, ValueError,
                                "R in"),
        "float64": ([g, g.double()], TypeError, "dtype"),
        "bfloat16": ([g.bfloat16()], TypeError, "dtype"),
        "shapes differ": ([g, torch.ones((4, 4))], ValueError, "shape"),
        "not contiguous": ([g, torch.ones((8, 16))[:, ::2]], ValueError,
                           "contiguous"),
        "the cpu": ([g, g], ValueError, "cuda tensors"),
        "meta": ([torch.empty((8, 8), device="meta")], ValueError,
                 "cuda tensors"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses_before_launch(case, monkeypatch):
    grams, exc, match = _refusals()[case]

    def no_build(*a, **k):
        raise AssertionError("the wrapper reached the launch")

    monkeypatch.setattr(_build, "launch", no_build)
    launched = dict(_build.LAUNCHES)
    with pytest.raises(exc, match=match):
        pinv.pinv_psd(grams)
    assert _build.LAUNCHES == launched
