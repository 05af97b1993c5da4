"""Cost model coefficients the static partitioning policies split on.

A copy of the part of the reference package's ``schedule/cost.py`` that
:mod:`repro_torch.schedule.static` needs: the coefficient record and the
per-index work model. The calibration, exchange-volume and streaming terms
belong to the rebalancer, which the port does not have yet.

With the default coefficients (``sec_per_nnz=1``, all else 0) the modelled
work of an index is exactly its nnz count, so every static policy reproduces
the historical nnz-histogram heuristics bit-for-bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CostCoefficients", "DEFAULT_COEFFS", "index_work"]


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """Linear EC-time model coefficients (seconds per unit)."""

    sec_per_nnz: float = 1.0         # per true nonzero
    sec_per_slot: float = 0.0        # per executed kernel slot (incl. padding)
    sec_per_row: float = 0.0         # per owned output index (static policies)
    sec_fixed: float = 0.0           # per-launch constant
    sec_per_h2d_byte: float = 0.0    # per streamed host→device byte


DEFAULT_COEFFS = CostCoefficients()


def index_work(hist: np.ndarray, coeffs: CostCoefficients = DEFAULT_COEFFS
               ) -> np.ndarray:
    """Modelled work of owning each index of a mode: its nonzeros plus the
    per-row output cost. With default coefficients this is exactly the nnz
    histogram — the quantity the historical strategy heuristics split on."""
    return (hist.astype(np.float64) * coeffs.sec_per_nnz
            + coeffs.sec_per_row)
