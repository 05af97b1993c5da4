"""The plain reference against dense einsums, and the roofline's count."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from chipbench import check, roofline
from chipbench.reference import cp_als


def _tensor(shape, nnz, seed=0):
    rng = np.random.default_rng(seed)
    flat = rng.choice(int(np.prod(shape)), size=nnz, replace=False)
    ind = np.stack(np.unravel_index(flat, shape), 1).astype(np.int32)
    return ind, rng.standard_normal(nnz).astype(np.float32)


def _dense(shape, ind, val):
    x = np.zeros(shape)
    x[tuple(ind.T)] = val
    return x


@pytest.mark.parametrize("shape", [(6, 5, 4), (4, 3, 5, 3, 2)])
def test_mttkrp_is_the_dense_einsum(shape):
    ind, val = _tensor(shape, 40)
    rng = np.random.default_rng(2)
    fs = [rng.standard_normal((s, 3)) for s in shape]
    x = _dense(shape, ind, val)
    letters = "abcde"[:len(shape)]
    for d in range(len(shape)):
        ops = [x] + [fs[w] for w in range(len(shape)) if w != d]
        spec = letters + "," + ",".join(f"{letters[w]}r" for w in
                                         range(len(shape)) if w != d)
        want = np.einsum(f"{spec}->{letters[d]}r", *ops)
        got = cp_als._mttkrp(torch.from_numpy(ind),
                             torch.from_numpy(val).double(),
                             [torch.from_numpy(f) for f in fs], d)
        assert np.allclose(got.numpy(), want, atol=1e-12)


def test_sweep_is_the_dense_als_update():
    shape = (6, 5, 4)
    ind, val = _tensor(shape, 50, seed=3)
    rng = np.random.default_rng(4)
    fs = [rng.uniform(0.1, 1, (s, 3)) for s in shape]
    x = _dense(shape, ind, val)
    got_f, got_lam, got_fit = cp_als.sweep(ind, val, fs)
    f = [a.copy() for a in fs]
    eq = ["ajk,jr,kr->ar", "ajk,ar,kr->jr", "ajk,ar,jr->kr"]
    for d in range(3):
        m = np.einsum(eq[d], x, *[f[w] for w in range(3) if w != d])
        v = np.prod([f[w].T @ f[w] for w in range(3) if w != d], axis=0)
        new = m @ np.linalg.pinv(v)
        lam = np.linalg.norm(new, axis=0)
        f[d] = new / lam
    model = np.einsum("r,ar,jr,kr->ajk", lam, *f)
    fit = 1 - np.linalg.norm(x - model) / np.linalg.norm(x)
    for a, b in zip(got_f, f):
        assert np.allclose(a, b, atol=1e-10)
    assert np.allclose(got_lam, lam, rtol=1e-10)
    assert got_fit == pytest.approx(fit, abs=1e-10)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159, 1e-30], dtype=torch.float32)
    y = cp_als.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0                      # a tie rounds to even
    assert y[3] == 1.0 + 2 ** -9
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
    assert torch.allclose(y, x, rtol=2 ** -11)


def test_the_tf32_control_reads_far_above_float32():
    shape = (30, 20, 10)
    ind, val = _tensor(shape, 1500, seed=5)
    rng = np.random.default_rng(6)
    fs = [rng.uniform(0.1, 1, (s, 8)) for s in shape]
    ref = cp_als.sweep(ind, val, fs)
    f32 = [f.astype(np.float32) for f in fs]
    ctl = cp_als.sweep(ind, val, f32, precision="tf32")
    got = check.gaps(*ctl, ref)
    assert got["factor_gap"] > 1e-4
    assert check.gaps(*ref, ref) == dict.fromkeys(check.NAMES[:3], 0.0)
    m, v = cp_als.last_mode(ind, val, ref[0])
    f = torch.from_numpy(ref[0][-1] * ref[1])
    assert cp_als.solve_gap(f, m, v) < 1e-14
    m32, v32 = cp_als.last_mode(ind, val, ref[0], precision="tf32")
    assert cp_als.solve_gap(cp_als.tf32_solve(m32, v32), m, v) > 1e-5


def test_the_last_mode_is_what_the_sweep_solved():
    shape = (6, 5, 4)
    ind, val = _tensor(shape, 50, seed=7)
    rng = np.random.default_rng(8)
    fs = [rng.uniform(0.1, 1, (s, 3)) for s in shape]
    f, lam, fit = cp_als.sweep(ind, val, fs)
    m, v = cp_als.last_mode(ind, val, f)
    x = _dense(shape, ind, val)
    assert np.allclose(m.numpy(), np.einsum("ajk,ar,jr->kr", x, f[0], f[1]),
                       atol=1e-12)
    assert np.allclose(v.numpy(), (f[0].T @ f[0]) * (f[1].T @ f[1]))
    # the last factor solves its normal equations, and the state's fit is
    # the sweep's
    assert cp_als.solve_gap(torch.from_numpy(f[-1] * lam), m, v) < 1e-14
    bad = f[-1] * lam
    bad[1, 1] += 0.01 * np.abs(bad).max()
    assert cp_als.solve_gap(torch.from_numpy(bad), m, v) > 1e-4
    norm_x = float(np.linalg.norm(val.astype(np.float64)))
    assert cp_als.state_fit(m, v, f[-1], lam, norm_x) == \
        pytest.approx(fit, abs=1e-12)


def test_gaps_of_a_misshapen_or_nan_answer_are_judged_wrong():
    ref = ([np.ones((3, 2)), np.ones((4, 2))], np.ones(2), 0.5)
    limits = dict.fromkeys(check.NAMES, 1.0)
    end = {"end_solve_gap": 0.0}
    got = check.gaps([np.ones((2, 2)), np.ones((4, 2))], np.ones(2), 0.5, ref)
    assert not check.judge(got | end, limits)
    bad = np.ones((4, 2))
    bad[1, 1] = np.nan
    got = check.gaps([np.ones((3, 2)), bad], np.ones(2), 0.5, ref)
    assert not check.judge(got | end, limits)
    assert check.judge(check.gaps(*ref, ref) | end, limits)
    nan_end = {"end_solve_gap": float("nan")}
    assert not check.judge(check.gaps(*ref, ref) | nan_end, limits)


def test_ec_bytes_and_operations_by_hand():
    # 3 modes of 10, 20, 30 rows, every row holding a nonzero, 100
    # nonzeros, rank 4: per mode 100 * (3 * 4 + 4) B of nonzeros and
    # (10 + 20 + 30) * 4 * 4 B of factors; 100 * 3 * 4 operations.
    shape = (10, 20, 30)
    nbytes, flops = roofline.ec_sweep_work(shape, shape, 100, 4)
    assert nbytes == 3 * (1600 + 960)
    assert flops == 3 * 1200
    bound, side = roofline.ec_sweep_bound_s(shape, shape, 100, 4)
    assert side == "bytes" and bound == pytest.approx(7680 / 3.35e12)
    bound4, _ = roofline.ec_sweep_bound_s(shape, shape, 100, 4, cards=4)
    assert bound4 == pytest.approx(bound / 4)
    # with 2, 5 and 7 rows holding a nonzero, mode 0 reads 5 + 7 rows
    # and writes 10, mode 1 reads 2 + 7 and writes 20, mode 2 reads 2 + 5
    # and writes 30: (22 + 29 + 37) rows of 16 B over the sweep
    nbytes, _ = roofline.ec_sweep_work(shape, (2, 5, 7), 100, 4)
    assert nbytes == 3 * 1600 + (22 + 29 + 37) * 16
    # the smoke's amazon tensor: 0.318 ms a sweep on one card
    amazon, _ = roofline.ec_sweep_bound_s((144_636, 53_228, 54_156),
                                          (144_636, 53_228, 54_156),
                                          20_181_049, 32)
    assert amazon == pytest.approx(0.318e-3, rel=2e-3)
