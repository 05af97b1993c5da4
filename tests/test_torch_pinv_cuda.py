"""The ALS solve's pseudo-inverse kernel (``kernels/pinv.pinv_psd``,
``csrc/pinv_psd.cu``) on the card.

Each input is held against a float64 ``eigh`` pseudo-inverse of the same
f32 ``V`` with the same cut: the kernel's error must be no larger than that
of ``torch.linalg.eigh``'s f32 path on the card (``pinv_psd_plain``, what
the solve ran before the kernel), or than a small floor. Inputs: Hadamard
products of grams of uniform(0.1, 1) factors (the solver's), a
rank-deficient ``V`` (the cut engaged), the zero matrix, a diagonal ``V``,
repeated eigenvalues and a condition number near 1e6, at R in {1, 2, 3, 8,
16, 30, 32, 64} (``pinv_psd_kernel``) and {65, 100, 127, 128}
(``pinv_psd_packed_kernel``, A's upper triangle updated in place). Also:
the same bits on repeated calls and on a second card, no synchronisation,
the Jacobi converging before its last sweep, and refusals before any
launch.

Marked ``gpu``: skipped where no card is present, which the fixture below
decides at run time. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_pinv_cuda.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as api  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import als  # noqa: E402
from repro_torch.core.coo import random_sparse  # noqa: E402
from repro_torch.kernels import _build, pinv  # noqa: E402

pytestmark = pytest.mark.gpu

RANKS = [1, 2, 3, 8, 16, 30, 32, 64, 65, 100, 127, 128]
KINDS = ["factors", "rank_deficient", "zero", "diagonal", "repeated",
         "kappa_1e6"]
# the error floor, relative to max|V⁺|: a few f32 roundings
FLOOR = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sym(m):
    return ((m + m.T) / 2).astype(np.float32)


def _grams(kind, rank, seed=0):
    """f32 CPU grams whose left-to-right product is the case's ``V``."""
    rng = np.random.default_rng(seed + 1000 * rank)
    if kind == "factors":   # three grams, as a four-mode tensor's solve
        fs = [rng.uniform(0.1, 1.0, size=(4 * rank + 7, rank))
              .astype(np.float32) for _ in range(3)]
        return [torch.from_numpy(f).T @ torch.from_numpy(f) for f in fs]
    if kind == "rank_deficient":   # exact in f32: small integers
        b = rng.integers(-3, 4, size=(rank, rank // 2)).astype(np.float32)
        return [torch.from_numpy(b @ b.T)]
    if kind == "zero":
        return [torch.zeros((rank, rank)), torch.zeros((rank, rank))]
    if kind == "diagonal":
        return [torch.from_numpy(np.diag(rng.uniform(0.5, 2.0, rank))
                                 .astype(np.float32))]
    q, _ = np.linalg.qr(rng.normal(size=(rank, rank)))
    if kind == "repeated":
        w = np.where(np.arange(rank) < rank // 2, 1.0, 3.0)
    else:
        w = np.logspace(0, -6, rank) if rank > 1 else np.ones(1)
    return [torch.from_numpy(_sym((q * w) @ q.T))]


def _v(grams):
    return functools.reduce(lambda a, b: a * b, grams)


def _pinv64(v, rcond=pinv.RCOND):
    w, u = np.linalg.eigh(v.double().numpy())
    keep = w > rcond * np.abs(w).max()
    w_inv = np.where(keep, 1.0 / np.where(keep, w, 1.0), 0.0)
    return (u * w_inv) @ u.T


def _err(got, want):
    return float(np.abs(got.double().cpu().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rank", RANKS)
def test_kernel_is_at_least_as_close_as_f32_eigh(cuda, kind, rank):
    grams = _grams(kind, rank)
    v = _v(grams)
    want = _pinv64(v)
    dev = [g.to(cuda) for g in grams]
    sweeps = torch.zeros(1, dtype=torch.int32, device=cuda)
    launched = _build.LAUNCHES["pinv_psd"]
    got = pinv.pinv_psd(dev, sweeps=sweeps)
    assert _build.LAUNCHES["pinv_psd"] == launched + 1
    plain = pinv.pinv_psd_plain(v.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rank, rank)
    assert torch.equal(got, got.T)
    assert 0 <= int(sweeps) < pinv.MAX_SWEEPS
    e_kernel, e_eigh = _err(got, want), _err(plain, want)
    assert e_kernel <= max(e_eigh, FLOOR), (e_kernel, e_eigh, int(sweeps))
    if kind == "zero":
        assert not got.any()
    if kind == "diagonal":
        assert int(sweeps) == 0


@pytest.mark.parametrize("rank", [3, 32, 64, 128])
def test_same_bits_on_repeated_calls_and_cards(cuda, rank):
    grams = _grams("factors", rank, seed=5)
    first = pinv.pinv_psd([g.to(cuda) for g in grams])
    for _ in range(3):
        assert torch.equal(pinv.pinv_psd([g.to(cuda) for g in grams]), first)
    for k in range(1, torch.cuda.device_count()):
        other = pinv.pinv_psd([g.to(f"cuda:{k}") for g in grams])
        assert torch.equal(other.cpu(), first.cpu())


@pytest.mark.parametrize("rank", [32, 128])
def test_kernel_does_not_synchronise(cuda, rank):
    grams = [g.to(cuda) for g in _grams("factors", rank)]
    torch.cuda.synchronize()
    before = obs.get_registry().counter("als.pinv.kernel")
    torch.cuda.set_sync_debug_mode("error")
    try:
        direct = pinv.pinv_psd(grams)
        solved = als._pinv_psd(grams)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(direct, solved)
    assert obs.get_registry().counter("als.pinv.kernel") == before + 1


def test_rank_above_the_limit_is_refused_on_the_card(cuda):
    """The card has no other version: above R 128 the solve's
    pseudo-inverse raises before any launch, and counts nothing."""
    grams = [g.to(cuda) for g in _grams("factors", 129)]
    launched = _build.LAUNCHES["pinv_psd"]
    reg = obs.get_registry()
    before = (reg.counter("als.pinv.kernel"), reg.counter("als.pinv.plain"))
    for call in (als._pinv_psd, pinv.pinv_psd):
        with pytest.raises(ValueError, match="R in"):
            call(grams)
    assert _build.LAUNCHES["pinv_psd"] == launched
    assert (reg.counter("als.pinv.kernel"),
            reg.counter("als.pinv.plain")) == before


def test_refuses_mixed_cards_and_dtypes_before_launch(cuda):
    g = torch.ones((8, 8), device=cuda)
    launched = _build.LAUNCHES["pinv_psd"]
    with pytest.raises(TypeError, match="dtype"):
        pinv.pinv_psd([g, g.double()])
    with pytest.raises(ValueError, match="is on cpu"):
        pinv.pinv_psd([g, g.cpu()])
    assert _build.LAUNCHES["pinv_psd"] == launched


def test_sweep_on_the_card_takes_the_kernel(cuda):
    """Every mode's solve on the card takes the kernel, once per mode and
    sweep, and the fits follow the CPU's to 1e-4."""
    t = random_sparse((40, 30, 20), 600, seed=7, distribution="zipf")
    cfg = api.preset("sorted", {"rank": 8, "kernel.autotune": False,
                                "runtime.tol": 0.0, "runtime.num_devices": 1})
    plan = api.plan(t, cfg)
    reg = obs.get_registry()
    kernel = reg.counter("als.pinv.kernel")
    launched = _build.LAUNCHES["pinv_psd"]
    fits = api.compile(plan, cfg, device=cuda).run(5).fits
    assert reg.counter("als.pinv.kernel") == kernel + 5 * 3
    assert _build.LAUNCHES["pinv_psd"] == launched + 5 * 3
    cpu = api.compile(plan, cfg, device="cpu").run(5).fits
    np.testing.assert_allclose(fits, cpu, atol=1e-4)
