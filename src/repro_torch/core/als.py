"""CP-ALS on top of the one-device MTTKRP (paper Algorithm 1 + §2.1.4).

The counterpart of the reference package's ``core/als.py``. One ALS sweep
updates every mode in sequence:

    M_d   = MTTKRP(X_(d), {F_w}_{w≠d})
    V_d   = ⊛_{w≠d} (F_wᵀ F_w)                  (R×R Hadamard of grams)
    F_d   = M_d V_d⁺,  λ = colnorms(F_d),  F_d /= λ

with the fit computed from the norm identity (no residual tensor is ever
materialised):

    ||X̂||² = λᵀ (⊛_w G_w) λ,   ⟨X, X̂⟩ = Σ (M_last ⊛ F_last) λ

Grams are cached across modes; only the updated mode's gram is recomputed.

Nothing in a sweep reads a result on the host: the fit it appends is a 0-d
device tensor, read only when the caller asks. (On CUDA,
``torch.linalg.eigh`` synchronises once per mode for its own error check,
so the host waits for each mode's EC before it enqueues that mode's solve.)

Factor matrices live in the padded ownership layout of their mode (see
core/partition.py); padding rows are zero and stay zero.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import mttkrp as dmttkrp
from repro_torch.core.partition import CPPlan

__all__ = ["ALSState", "init_factors", "make_mode_update",
           "make_sweep_updates", "als_sweep", "fit_from_stats",
           "unpad_factors"]


@dataclasses.dataclass
class ALSState:
    factors: list[torch.Tensor]    # per mode, padded layout
    lam: torch.Tensor              # (R,) column scales
    grams: list[torch.Tensor]      # per mode, (R, R) = F_wᵀ F_w
    sweep: int = 0
    # 0-d device tensors (or floats after a host read) — reading one blocks.
    fits: list = dataclasses.field(default_factory=list)


def init_factors(plan: CPPlan, rank: int, seed: int = 0, *,
                 device) -> list[torch.Tensor]:
    """Random factors in padded layout; padding rows exactly zero. The same
    numpy draw as the reference (als.py:53-63), so both packages start from
    the same factors."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(plan.nmodes):
        rows = plan.modes[w].padded_rows
        f = np.zeros((rows, rank), np.float32)
        g2p = plan.global_to_padded[w]
        f[g2p] = rng.uniform(0.1, 1.0, size=(plan.shape[w], rank)).astype(np.float32)
        out.append(torch.from_numpy(f).to(device))
    return out


def _pinv_psd(v: torch.Tensor, rcond: float = 1e-8) -> torch.Tensor:
    """Pseudo-inverse of a symmetric PSD R×R matrix via eigh (stable, tiny)."""
    w, u = torch.linalg.eigh(v)
    w_inv = torch.where(w > rcond * w.abs().max(), 1.0 / w,
                        torch.zeros_like(w))
    return (u * w_inv[None, :]) @ u.T


def make_mode_update(plan: CPPlan, mode: int, **mttkrp_kw) -> Callable:
    """``(F_d_old, dev_arrays, other_factors, grams) -> (F_d, G_d, M_d, lam)``.

    ``other_factors`` is the factor list *without* mode ``mode``; the old
    output-mode factor is passed separately because the update overwrites
    it in place: the reference donates that buffer to XLA (als.py:101), and
    here ``F_d`` is written into ``F_d_old``'s storage, saving one
    padded_d×R allocation per update. Do not read a factor of an
    ``ALSState`` from before the sweep that replaced it.
    """
    mfn = dmttkrp.make_mttkrp_fn(plan.modes[mode], **mttkrp_kw)
    n = plan.nmodes

    def update(f_old: torch.Tensor, dev, other_factors: Sequence[torch.Tensor],
               grams: Sequence[torch.Tensor]):
        factors = list(other_factors[:mode]) + [f_old] + \
            list(other_factors[mode:])
        m = mfn(dev, factors)                             # (padded_d, R)
        v = functools.reduce(
            lambda a, b: a * b,
            [grams[w] for w in range(n) if w != mode])     # (R, R)
        # the EC ignores the output mode's factor, so F_d_old is free now
        f_new = torch.matmul(m, _pinv_psd(v), out=f_old)
        lam = torch.linalg.vector_norm(f_new, dim=0)
        lam = torch.where(lam > 0, lam, torch.ones_like(lam))
        f_new.div_(lam[None, :])
        g_new = f_new.T @ f_new
        return f_new, g_new, m, lam

    return update


def make_sweep_updates(plan: CPPlan, **mttkrp_kw) -> list[Callable]:
    """One :func:`make_mode_update` per mode, sharing ``mttkrp_kw`` (kernel
    variant, num_buffers). Build once, pass to every :func:`als_sweep` —
    this is what :class:`repro_torch.api.CPSolver` owns."""
    return [make_mode_update(plan, d, **mttkrp_kw)
            for d in range(plan.nmodes)]


def fit_from_stats(norm_x: float, m_last, f_last, lam, grams) -> torch.Tensor:
    """fit = 1 - ||X - X̂||_F / ||X||_F via the norm identity; a 0-d tensor
    on the factors' device."""
    inner = torch.sum(torch.sum(m_last * f_last, dim=0) * lam)
    gall = functools.reduce(lambda a, b: a * b, grams)
    model_sq = lam @ gall @ lam
    resid_sq = torch.clamp(norm_x ** 2 - 2.0 * inner + model_sq, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / norm_x


def als_sweep(plan: CPPlan, dev_arrays: Sequence, state: ALSState,
              updates: Sequence[Callable] | None = None,
              **mttkrp_kw) -> ALSState:
    """One full sweep over all modes (Algorithm 1). Multi-sweep callers
    pass ``updates`` (from :func:`make_sweep_updates`).

    The fit is appended as a 0-d device tensor and forces a host sync only
    when read (see the module docstring for eigh's own sync). Each mode's
    updated factor overwrites the old one in place (see
    :func:`make_mode_update`)."""
    n = plan.nmodes
    if updates is None:
        updates = make_sweep_updates(plan, **mttkrp_kw)
    factors, grams = list(state.factors), list(state.grams)
    m_last = f_last = lam = None
    for d in range(n):
        others = [factors[w] for w in range(n) if w != d]
        f_d, g_d, m_d, lam = updates[d](factors[d], dev_arrays[d], others,
                                        grams)
        factors[d], grams[d] = f_d, g_d
        m_last, f_last = m_d, f_d
    fit = fit_from_stats(plan.norm, m_last, f_last, lam, grams)
    return ALSState(factors=factors, lam=lam, grams=grams,
                    sweep=state.sweep + 1, fits=state.fits + [fit])


def unpad_factors(plan: CPPlan, factors: Sequence[torch.Tensor]
                  ) -> list[np.ndarray]:
    """Padded ownership layout → global row order (I_w, R), on the host."""
    return [f.detach().cpu().numpy()[plan.global_to_padded[w]]
            for w, f in enumerate(factors)]
