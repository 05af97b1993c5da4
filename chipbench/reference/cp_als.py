"""The plain reference: one CP-ALS sweep in float64, from the COO tensor
and the factors that enter the sweep.

It imports torch alone, nothing of the program. It works each MTTKRP out
again from the nonzeros (gather the other modes' rows, take their product
with the value, add it into the output row), then the update of every
mode in turn, as the paper's Algorithm 1 states it:

    M_d = MTTKRP(X, {F_w}_{w != d});  V_d = Hadamard of the grams F_w^T F_w
    F_d = M_d V_d^+;  lam = column norms of F_d;  F_d /= lam

and the fit from the norm identity, 1 - ||X - X^||_F / ||X||_F, with
``<X, X^> = sum((M_last * F_last) lam)`` and
``||X^||^2 = lam^T (Hadamard of all grams) lam``.

At a given state, :func:`last_mode` works out what the last mode's update
solves, ``F V = M``, so that :func:`solve_gap` can judge the state's last
factor by its normal equations, and :func:`state_fit` gives its fit: no
solve in float64, which late in a run would be ill-conditioned.

``precision="tf32"`` is the control: the same sweep in float32 with every
matrix product's operands rounded to TF32 (10 mantissa bits, as the tensor
cores round them), the step below the program's float32 with TF32 off.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["sweep", "last_mode", "tf32_solve", "solve_gap", "state_fit",
           "tf32_round", "RCOND"]

# Eigenvalues at or below this share of the largest are left out of V^+.
RCOND = 1e-8
# Nonzeros per gather block: (block, rank) float64 rows, 1 GiB at rank 32.
BLOCK = 1 << 22


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def _mttkrp(ind, val, factors, mode: int) -> torch.Tensor:
    rows, rank = factors[mode].shape
    out = torch.zeros((rows, rank), dtype=val.dtype, device=val.device)
    for s in range(0, val.shape[0], BLOCK):
        blk = ind[s:s + BLOCK].long()
        prod = val[s:s + BLOCK, None].expand(-1, rank).clone()
        for w, f in enumerate(factors):
            if w != mode:
                prod.mul_(f[blk[:, w]])
        out.index_add_(0, blk[:, mode], prod)
    return out


def _pinv_psd(v: torch.Tensor) -> torch.Tensor:
    w, u = torch.linalg.eigh(v)
    keep = w > RCOND * w.abs().max()
    w_inv = torch.where(keep, 1.0 / w, torch.zeros_like(w))
    return (u * w_inv[None, :]) @ u.T


def _load(indices, values, factors, device, precision):
    if precision not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    dtype = torch.float32 if tf32 else torch.float64
    ind = torch.from_numpy(np.ascontiguousarray(indices)).to(device)
    val = torch.from_numpy(np.ascontiguousarray(values)).to(device, dtype)
    fs = [torch.from_numpy(np.asarray(f)).to(device, dtype) for f in factors]
    norm_x = torch.linalg.vector_norm(
        torch.from_numpy(np.asarray(values, np.float64)))
    return tf32, ind, val, fs, norm_x


def sweep(indices: np.ndarray, values: np.ndarray, factors, *,
          device="cpu", precision: str = "float64"):
    """One sweep over every mode from ``factors`` (host ``(I_w, R)``
    arrays, global row order). Returns host ``(factors, lam, fit)``."""
    tf32, ind, val, fs, norm_x = _load(indices, values, factors, device,
                                       precision)
    grams = [_mm(f.T, f, tf32) for f in fs]
    m = lam = None
    for d in range(len(fs)):
        m = _mttkrp(ind, val, fs, d)
        v = functools.reduce(torch.mul,
                             [g for w, g in enumerate(grams) if w != d])
        f = _mm(m, _pinv_psd(v), tf32)
        lam = torch.linalg.vector_norm(f, dim=0)
        lam = torch.where(lam > 0, lam, torch.ones_like(lam))
        fs[d] = f / lam
        grams[d] = _mm(fs[d].T, fs[d], tf32)
    inner = torch.sum(torch.sum(m * fs[-1], dim=0) * lam).double().cpu()
    gall = functools.reduce(torch.mul, grams)
    model_sq = (lam @ gall @ lam).double().cpu()
    resid_sq = torch.clamp(norm_x ** 2 - 2.0 * inner + model_sq, min=0.0)
    fit = float(1.0 - torch.sqrt(resid_sq) / norm_x)
    return ([f.double().cpu().numpy() for f in fs],
            lam.double().cpu().numpy(), fit)


def last_mode(indices: np.ndarray, values: np.ndarray, factors, *,
              device="cpu", precision: str = "float64"):
    """What the last mode's update solves at ``factors``: its MTTKRP ``M``
    and ``V``, the Hadamard product of the other modes' grams
    (``F V = M``), on ``device``."""
    tf32, ind, val, fs, _ = _load(indices, values, factors, device,
                                  precision)
    m = _mttkrp(ind, val, fs, len(fs) - 1)
    v = functools.reduce(torch.mul, [_mm(f.T, f, tf32) for f in fs[:-1]])
    return m, v


def tf32_solve(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``F = M V^+`` with the product's operands in TF32: the control's
    update from ``last_mode(..., precision="tf32")``."""
    return _mm(m, _pinv_psd(v), True)


def solve_gap(f: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> float:
    """``||F V - M||_F / (||F||_F ||V||_2)`` in float64: how far ``F``
    (unnormalised, ``factor * lam``) is from solving ``F V = M``, as a
    share of the sizes of ``F`` and ``V`` (the solve's backward error,
    which the conditioning of ``V`` does not amplify)."""
    f, m, v = f.to(m.device, torch.float64), m.double(), v.double()
    r = torch.linalg.matrix_norm(f @ v - m)
    den = torch.linalg.matrix_norm(f) * torch.linalg.matrix_norm(v, 2)
    return float(r / torch.clamp(den, min=1e-300))


def state_fit(m: torch.Tensor, v: torch.Tensor, factor, lam,
              norm_x: float) -> float:
    """The fit of a state whose last mode holds ``factor`` and ``lam``,
    from that mode's ``M`` and ``V`` (the norm identity)."""
    f = torch.as_tensor(np.asarray(factor)).to(m.device, torch.float64)
    lam = torch.as_tensor(np.asarray(lam)).to(m.device, torch.float64)
    inner = float(torch.sum(m.double() * f, dim=0) @ lam)
    model_sq = float(lam @ (v.double() * (f.T @ f)) @ lam)
    resid_sq = max(norm_x ** 2 - 2.0 * inner + model_sq, 0.0)
    return 1.0 - resid_sq ** 0.5 / norm_x
