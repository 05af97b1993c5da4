"""Static partitioning policies (paper §3.2, Fig. 6) over the cost model.

A copy of the reference package's ``schedule/static.py``, held bitwise
against it by the tests. Each policy answers two questions the layout
constructor (:mod:`repro_torch.core.partition`) asks before it builds device
arrays:

  * :meth:`StaticPolicy.replication` — does this strategy *force* an
    intra-group replication factor (``equal_nnz`` forces ``r = m``)?
    ``None`` defers to the caller (explicit argument or
    :func:`auto_replication`).
  * :meth:`StaticPolicy.assign` — which group owns each index of the output
    mode. All policies keep the AMPED invariant: an index is owned by
    exactly one group, so group outputs never conflict.

Policies split on :func:`repro_torch.schedule.cost.index_work` — the
modelled work of owning an index — rather than the raw nnz histogram. With
the default coefficients the two are proportional.
"""
from __future__ import annotations

import numpy as np

from repro_torch.schedule import cost as cost_mod
from repro_torch.schedule.cost import CostCoefficients, DEFAULT_COEFFS

__all__ = ["StaticPolicy", "CdfPolicy", "LptPolicy", "UniformIndexPolicy",
           "EqualNnzPolicy", "POLICIES", "POLICY_NAMES", "get_policy",
           "auto_replication"]


def auto_replication(hist: np.ndarray, num_devices: int) -> int:
    """Pick the intra-group replication ``r`` for one mode.

    Rules (all powers of two dividing ``num_devices``):
      * groups must not outnumber rows that exist: ``m/r <= max(len(hist),1)``
      * a single hot index caps achievable balance at ``c_max``; raise ``r``
        until ``c_max/r`` is below the mean per-device load.
    """
    m = num_devices
    nnz = int(hist.sum())
    c_max = int(hist.max()) if hist.size else 0
    r = 1
    while r < m and m // r > max(int(hist.size), 1):
        r *= 2
    if nnz > 0:
        mean_load = nnz / m
        while r < m and c_max / r > 2.0 * mean_load:
            r *= 2
    while m % r:  # keep r a divisor of m
        r //= 2
    return max(1, r)


class StaticPolicy:
    """Base policy: owner-group assignment over modelled index work."""

    name: str = "abstract"

    def replication(self, hist: np.ndarray, num_devices: int) -> int | None:
        """Forced replication factor, or None to defer to the caller."""
        return None

    def assign(self, hist: np.ndarray, n_groups: int,
               coeffs: CostCoefficients = DEFAULT_COEFFS) -> np.ndarray:
        """owner_group per index, int32, each in [0, n_groups)."""
        raise NotImplementedError


def _uniform_assign(n_idx: int, n_groups: int) -> np.ndarray:
    per = -(-n_idx // n_groups)
    return (np.arange(n_idx) // per).astype(np.int32)


class UniformIndexPolicy(StaticPolicy):
    """Paper §3.2 literal: equal-sized contiguous index partitions —
    oblivious to the cost model (the baseline the CDF split improves on)."""

    name = "uniform_index"

    def assign(self, hist, n_groups, coeffs=DEFAULT_COEFFS):
        return _uniform_assign(hist.size, n_groups)


class CdfPolicy(StaticPolicy):
    """AMPED's scheme: contiguous split at work-CDF quantiles → near-equal
    modelled work per group."""

    name = "amped_cdf"

    def assign(self, hist, n_groups, coeffs=DEFAULT_COEFFS):
        n_idx = hist.size
        if n_idx == 0:
            return np.zeros(0, np.int32)
        work = cost_mod.index_work(hist, coeffs)
        cdf = np.cumsum(work, dtype=np.float64)
        total = cdf[-1] if cdf.size else 0.0
        if total == 0:
            return _uniform_assign(n_idx, n_groups)
        owner = np.minimum(
            (cdf - work / 2.0) * n_groups / total, n_groups - 1e-9
        ).astype(np.int32)
        return np.maximum.accumulate(owner)  # enforce monotone contiguity


class LptPolicy(StaticPolicy):
    """Contiguous index blocks, longest-processing-time assignment by
    modelled block work — the static stand-in for the paper's many-shards +
    dynamic pull."""

    name = "amped_lpt"

    def __init__(self, block: int = 64):
        self.block = block

    def assign(self, hist, n_groups, coeffs=DEFAULT_COEFFS):
        n_idx = hist.size
        if n_idx == 0:
            return np.zeros(0, np.int32)
        block = self.block
        work = cost_mod.index_work(hist, coeffs)
        nb = -(-n_idx // block)
        bc = np.add.reduceat(work, np.arange(0, n_idx, block))
        order = np.argsort(-bc, kind="stable")
        load = np.zeros(n_groups, np.float64)
        b_owner = np.zeros(nb, np.int32)
        for b in order:
            g = int(np.argmin(load))
            b_owner[b] = g
            load[g] += float(bc[b])
        return b_owner[np.arange(n_idx) // block].astype(np.int32)


class EqualNnzPolicy(StaticPolicy):
    """Paper Fig. 6 "equal nnz" baseline: a single group owning every index,
    replication forced to the full device count so the group's nonzeros
    split evenly across all members (merged by reduce-scatter)."""

    name = "equal_nnz"

    def replication(self, hist, num_devices):
        return num_devices

    def assign(self, hist, n_groups, coeffs=DEFAULT_COEFFS):
        return np.zeros(hist.size, np.int32)


POLICIES: dict[str, StaticPolicy] = {
    p.name: p for p in (CdfPolicy(), LptPolicy(), UniformIndexPolicy(),
                        EqualNnzPolicy())
}
POLICY_NAMES = tuple(sorted(POLICIES))


def get_policy(name: str) -> StaticPolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown partitioning policy {name!r}; expected "
                         f"one of {sorted(POLICIES)}")
    return POLICIES[name]
