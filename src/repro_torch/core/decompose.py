"""The host-side result of a CP decomposition.

A copy of :class:`CPResult` from the reference package's
``core/decompose.py`` (with its coordinate check); the deprecated one-call
``cp_decompose`` shim is not ported — the staged API in
:mod:`repro_torch.api` replaces it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.partition import CPPlan

__all__ = ["CPResult", "validate_coords"]


def validate_coords(indices: np.ndarray, shape: tuple[int, ...], *,
                    what: str = "coordinate") -> np.ndarray:
    """Bounds-check a ``(k, nmodes)`` coordinate batch against ``shape``.

    Numpy fancy indexing wraps negatives and only faults past ``-I_w``, so
    an unvalidated bad coordinate silently scores the wrong row. Raises
    ``IndexError`` naming the offending mode and row; returns the batch as
    a contiguous int64 array."""
    ind = np.asarray(indices)
    if ind.ndim != 2 or ind.shape[1] != len(shape):
        raise ValueError(f"{what}s must be (k, {len(shape)}), "
                         f"got shape {tuple(ind.shape)}")
    ind = ind.astype(np.int64, copy=False)
    for w, size in enumerate(shape):
        col = ind[:, w]
        bad = (col < 0) | (col >= size)
        if bad.any():
            row = int(np.flatnonzero(bad)[0])
            raise IndexError(
                f"mode {w}: {what} {int(col[row])} at row {row} is out of "
                f"range [0, {size})")
    return ind


@dataclasses.dataclass
class CPResult:
    factors: list[np.ndarray]     # global layout (I_w, R)
    lam: np.ndarray               # (R,)
    fits: list[float]
    plan: CPPlan
    sweeps: int

    def reconstruct_at(self, indices: np.ndarray) -> np.ndarray:
        """Model values at the given coordinates (nnz, N) — for evaluation:
        ``x̂[i] = Σ_r λ_r · Π_w F_w[indices[i, w], r]``. Coordinates are
        bounds-checked per mode (``IndexError`` on any out-of-range row)."""
        shape = tuple(int(f.shape[0]) for f in self.factors)
        indices = validate_coords(indices, shape)
        acc = np.ones((indices.shape[0], self.lam.shape[0]), np.float64)
        for w, f in enumerate(self.factors):
            acc *= np.asarray(f, np.float64)[indices[:, w]]
        return acc @ np.asarray(self.lam, np.float64)
