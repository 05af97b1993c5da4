"""The comparison that decides ``correct``: the program's first sweep of
the window against the plain reference's sweep from the same entering
factors, and the last state of the run against the normal equations that
its last mode's update solves.

Four numbers, each against its limit in the cell's file:

- ``factor_gap``: over the modes, the widest gap of a factor entry, as a
  share of that mode's largest reference entry;
- ``lam_gap``: the widest gap of a column scale, as a share of the
  largest;
- ``fit_gap``: the gap of the fit;
- ``end_solve_gap``: at the end of the run, ``||F V - M||_F / (||F||_F
  ||V||_2)`` of the last mode's factor ``F`` (times ``lam``), with ``M``
  and ``V`` worked out in float64 from the nonzeros and the other modes'
  last factors (:func:`chipbench.reference.cp_als.solve_gap`).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["NAMES", "widest", "gaps", "judge"]

NAMES = ("factor_gap", "lam_gap", "fit_gap", "end_solve_gap")


def widest(got, want) -> float:
    """The widest entry gap of ``got`` from ``want``, as a share of
    ``want``'s largest entry."""
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def gaps(factors, lam, fit: float, ref) -> dict[str, float]:
    """The first three numbers for a sweep's ``(factors, lam, fit)`` against the
    reference's ``ref = (factors, lam, fit)``; NaN where the shapes
    disagree or a value is not finite."""
    rf, rl, rfit = ref
    if len(factors) != len(rf) or any(np.shape(a) != np.shape(b)
                                      for a, b in zip(factors, rf)):
        return dict.fromkeys(NAMES[:3], math.nan)
    # np.max, not max: a NaN in any mode has to come through
    return {"factor_gap": float(np.max([widest(a, b)
                                        for a, b in zip(factors, rf)])),
            "lam_gap": widest(lam, rl),
            "fit_gap": abs(float(fit) - rfit)}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every number is finite and at most its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NAMES)
