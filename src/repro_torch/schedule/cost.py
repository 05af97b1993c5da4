"""Explicit per-device cost model for MTTKRP scheduling.

A copy of the reference package's ``schedule/cost.py``, held bitwise
against it by the tests. Every scheduling decision — static group
assignment (:mod:`repro_torch.schedule.static`) and dynamic migration
(:mod:`repro_torch.schedule.rebalance`) — is expressed against one linear
model of a device's EC time for one mode:

    t_dev = sec_per_nnz  · nnz_true
          + sec_per_slot · (blocks_true · block_p)       # padded kernel slots
          + sec_fixed                                     # launch overhead

``nnz_true`` is the device's real nonzeros; ``blocks_true · block_p`` is what
the kernel *actually executes* — the per-tile padding the blocked layout
inserts (core/partition.py) makes these diverge on scattered shards, which is
why static nnz balancing mispredicts device time on skewed tensors. The row
term ``sec_per_row`` extends the model to per-owned-index output costs for
the static policies' index-work estimates.

Coefficients start at the nnz-proportional default (``sec_per_nnz=1``, all
else 0 — which makes the static policies reproduce the historical heuristics
bit-for-bit) and are *calibrated* from measured per-device EC times at
rebalance points, EWMA-smoothed across sweeps (:class:`EwmaCostModel`).

Exchange volume (:func:`exchange_bytes`) models the per-mode communication a
replication choice ``r`` implies: the intra-group reduce-scatter plus the
inter-group all-gather of the padded output factor (paper Algorithm 3).
:func:`device_stream_bytes` and ``sec_per_h2d_byte`` model the epoch
streaming transfer of the reference (0.0 by default: the resident path
transfers nothing per sweep; the H2D coefficient is never calibrated).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CostCoefficients", "DEFAULT_COEFFS", "index_work", "device_features",
    "predict_times", "fit_coefficients", "EwmaCostModel", "exchange_bytes",
    "device_stream_bytes", "mode_cost_summary",
]


@dataclasses.dataclass(frozen=True)
class CostCoefficients:
    """Linear EC-time model coefficients (seconds per unit)."""

    sec_per_nnz: float = 1.0         # per true nonzero
    sec_per_slot: float = 0.0        # per executed kernel slot (incl. padding)
    sec_per_row: float = 0.0         # per owned output index (static policies)
    sec_fixed: float = 0.0           # per-launch constant
    sec_per_h2d_byte: float = 0.0    # per streamed host→device byte (epoch
    #                                  streaming only; not calibrated)

    def as_array(self) -> np.ndarray:
        return np.array([self.sec_per_nnz, self.sec_per_slot, self.sec_fixed],
                        np.float64)


DEFAULT_COEFFS = CostCoefficients()


def index_work(hist: np.ndarray, coeffs: CostCoefficients = DEFAULT_COEFFS
               ) -> np.ndarray:
    """Modelled work of owning each index of a mode: its nonzeros plus the
    per-row output cost. With default coefficients this is exactly the nnz
    histogram — the quantity the historical strategy heuristics split on."""
    return (hist.astype(np.float64) * coeffs.sec_per_nnz
            + coeffs.sec_per_row)


def device_features(part) -> np.ndarray:
    """(m, 3) feature matrix for one :class:`ModePartition`: per device
    [true nnz, executed kernel slots (blocks_true · block_p), 1]."""
    nnz = np.asarray(part.nnz_true, np.float64)
    slots = np.asarray(part.blocks_true, np.float64) * float(part.block_p)
    return np.stack([nnz, slots, np.ones_like(nnz)], axis=1)


def device_stream_bytes(part, nmodes: int) -> np.ndarray:
    """(m,) host→device bytes each device streams for one mode epoch: its
    executed slots' index/value/row payload plus the block map and the tile
    mask (the same accounting as ``repro.store.plan.stream_shard_nbytes``,
    but per device at its true block count instead of the padded cap)."""
    slots = np.asarray(part.blocks_true, np.float64) * float(part.block_p)
    blocks = np.asarray(part.blocks_true, np.float64)
    n_tiles = part.rows_max // part.tile
    return slots * (4 * nmodes + 8) + blocks * 4 + float(n_tiles * 4)


def predict_times(part, coeffs: CostCoefficients = DEFAULT_COEFFS, *,
                  nmodes: int | None = None) -> np.ndarray:
    """Modelled per-device EC time for one mode, (m,) float64. With
    ``nmodes`` given and a nonzero ``sec_per_h2d_byte``, adds the epoch-
    streaming transfer term (exposed H2D time per device)."""
    t = device_features(part) @ coeffs.as_array()
    if nmodes is not None and coeffs.sec_per_h2d_byte > 0:
        t = t + coeffs.sec_per_h2d_byte * device_stream_bytes(part, nmodes)
    return t


def fit_coefficients(feats: np.ndarray, times: np.ndarray
                     ) -> CostCoefficients:
    """Least-squares fit of the linear model to measured device times, with
    coefficients projected to be non-negative (a negative per-unit time is
    never physical; negative components are zeroed and the rest refit)."""
    feats = np.asarray(feats, np.float64)
    times = np.asarray(times, np.float64)
    active = list(range(feats.shape[1]))
    coef = np.zeros(feats.shape[1])
    for _ in range(feats.shape[1]):
        sub, *_ = np.linalg.lstsq(feats[:, active], times, rcond=None)
        if (sub >= 0).all() or len(active) == 1:
            coef[:] = 0.0
            coef[active] = np.maximum(sub, 0.0)
            break
        active = [a for a, c in zip(active, sub) if c > 0] or [0]
    return CostCoefficients(sec_per_nnz=float(coef[0]),
                            sec_per_slot=float(coef[1]),
                            sec_fixed=float(coef[2]))


class EwmaCostModel:
    """Cost coefficients calibrated from measured EC times and smoothed with
    an exponentially-weighted moving average across rebalance points."""

    def __init__(self, alpha: float = 0.5,
                 coeffs: CostCoefficients = DEFAULT_COEFFS):
        self.alpha = float(alpha)
        self.coeffs = coeffs
        self.calibrated = False

    def update(self, feats: np.ndarray, times: np.ndarray) -> CostCoefficients:
        new = fit_coefficients(feats, times)
        if not self.calibrated:
            # first measurement replaces the prior — except the H2D term,
            # which is never in the calibration features (set explicitly)
            self.coeffs = dataclasses.replace(
                new, sec_per_h2d_byte=self.coeffs.sec_per_h2d_byte)
            self.calibrated = True
        else:
            a = self.alpha
            self.coeffs = CostCoefficients(
                sec_per_nnz=a * new.sec_per_nnz
                + (1 - a) * self.coeffs.sec_per_nnz,
                sec_per_slot=a * new.sec_per_slot
                + (1 - a) * self.coeffs.sec_per_slot,
                sec_per_row=self.coeffs.sec_per_row,
                sec_fixed=a * new.sec_fixed + (1 - a) * self.coeffs.sec_fixed,
                sec_per_h2d_byte=self.coeffs.sec_per_h2d_byte,
            )
        return self.coeffs

    def predict(self, part, *, nmodes: int | None = None) -> np.ndarray:
        return predict_times(part, self.coeffs, nmodes=nmodes)


def exchange_bytes(part, rank: int, *, dtype_bytes: int = 4) -> int:
    """Per-device exchange volume one mode update implies (paper Alg. 3):
    the intra-group reduce-scatter of the (rows_max, R) partial for r>1
    (each member sends (r-1)/r of it) plus the all-gather of every other
    device's owned slice of the padded output factor."""
    rs = 0
    if part.r > 1:
        rs = part.rows_max * rank * dtype_bytes * (part.r - 1) // part.r
    own_rows = part.rows_max // part.r if part.r > 1 else part.rows_max
    ag = (part.padded_rows - own_rows) * rank * dtype_bytes
    return int(rs + ag)


def mode_cost_summary(part, rank: int,
                      coeffs: CostCoefficients = DEFAULT_COEFFS, *,
                      nmodes: int | None = None) -> dict:
    """Human/JSON-facing cost breakdown for one mode: modelled per-device
    times, their imbalance (max/mean), and the exchange volume. With
    ``nmodes``, adds the per-device epoch-streaming H2D volume (and its time
    contribution to ``modelled_times`` when ``sec_per_h2d_byte`` is set)."""
    t = predict_times(part, coeffs, nmodes=nmodes)
    mean = float(t.mean()) if t.size else 0.0
    out = {
        "mode": int(part.mode),
        "modelled_times": [float(x) for x in t],
        "modelled_imbalance": float(t.max() / mean) if mean > 0 else 1.0,
        "exchange_bytes_per_device": exchange_bytes(part, rank),
        "padding_frac": float(part.balance_stats()["padding_frac"]),
    }
    if nmodes is not None:
        out["stream_bytes_per_device"] = [
            int(x) for x in device_stream_bytes(part, nmodes)]
    return out
