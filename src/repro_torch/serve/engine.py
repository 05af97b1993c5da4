"""Snapshot-serving query engine.

The counterpart of the reference package's ``serve/engine.py``. A
:class:`FactorSnapshot` is an immutable published CP model — GLOBAL-layout
``(I_w, R)`` fp32 factors plus the weight vector ``lam``, on one device
(the card unless ``device="cpu"``) — tagged with a monotonically increasing
version. A :class:`ServingEngine` holds exactly one published snapshot and
answers two query shapes against it:

* :meth:`ServingEngine.reconstruct_batch` — model values at a batch of
  coordinates, ``x̂[i] = Σ_r λ_r · Π_w F_w[idx[i, w], r]`` (the fp32 batch
  counterpart of :meth:`CPResult.reconstruct_at`);
* :meth:`ServingEngine.topk_slice` — top-k rows of one *free* mode by
  reconstruction score with every other mode's coordinate fixed: the fixed
  coordinates contract to a weight vector ``w_r = λ_r · Π_{u≠mode}
  F_u[c_u, r]`` and the scores are one ``(I_mode, R) @ (R,)`` product —
  never a dense reconstruction.

Both are plain torch operations (row gathers, products, a sum over R, a
matmul and ``torch.topk``), as the reference computes them with ``jnp``
under ``jax.jit``. Request sizes are padded up to power-of-two buckets
(with row 0 of every mode) exactly as in the reference, so the operations
see at most ``log2(max batch)`` distinct shapes per operation; there is no
trace to reuse here, but the bucket sets stay the engine's accounting
(gauges, and rule AH-H006 of :mod:`repro_torch.analysis`).

Publication is a single attribute swap (blue/green): in-flight queries keep
the snapshot object they started with, new queries see the new one, readers
never block on a refit. A snapshot's tensors are complete when it is built
(:meth:`FactorSnapshot.from_arrays` copies synchronously), and every query
holds its snapshot until its result has been copied to the host, which
waits for the query's kernels: so the caching allocator cannot hand a
dropped snapshot's memory to other work while a query still reads it, on
whichever thread and stream either runs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.api.solver import resolve_device
from repro_torch.core.decompose import CPResult, validate_coords
from repro_torch.serve.metrics import ServiceMetrics

__all__ = ["FactorSnapshot", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class FactorSnapshot:
    """One immutable published model version (device-resident, fp32)."""

    factors: tuple[torch.Tensor, ...]   # GLOBAL layout (I_w, R) each
    lam: torch.Tensor                   # (R,)
    shape: tuple[int, ...]
    rank: int
    version: int
    fit: float | None = None            # fit the publisher measured, if any
    created_unix: float = 0.0
    source: str = "unknown"

    @classmethod
    def from_arrays(cls, factors: Sequence[np.ndarray], lam: np.ndarray, *,
                    version: int, fit: float | None = None,
                    source: str = "arrays", device=None) -> "FactorSnapshot":
        """Copy host ``factors`` and ``lam`` to ``device`` (``None``: the
        card) as fp32; the copies are complete when this returns."""
        dev = resolve_device(device)
        facs = tuple(torch.tensor(np.asarray(f, np.float32), device=dev)
                     for f in factors)
        lam = torch.tensor(np.asarray(lam, np.float32), device=dev)
        if lam.ndim != 1 or any(f.ndim != 2 or f.shape[1] != lam.shape[0]
                                for f in facs):
            raise ValueError(
                f"inconsistent snapshot geometry: lam {tuple(lam.shape)}, "
                f"factor shapes {[tuple(f.shape) for f in facs]}")
        return cls(factors=facs, lam=lam,
                   shape=tuple(int(f.shape[0]) for f in facs),
                   rank=int(lam.shape[0]), version=version, fit=fit,
                   created_unix=time.time(), source=source)

    @classmethod
    def from_result(cls, result: CPResult, *, version: int = 1,
                    source: str = "result", device=None) -> "FactorSnapshot":
        return cls.from_arrays(
            result.factors, result.lam, version=version,
            fit=result.fits[-1] if result.fits else None, source=source,
            device=device)

    @property
    def device(self) -> torch.device:
        return self.lam.device

    def host_factors(self) -> list[np.ndarray]:
        """The factors on the host (a device-to-host copy: off the query
        path)."""
        return [f.cpu().numpy() for f in self.factors]

    def host_lam(self) -> np.ndarray:
        return self.lam.cpu().numpy()

    @property
    def age_s(self) -> float:
        return time.time() - self.created_unix


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= max(n, lo)."""
    return 1 << max(n - 1, lo - 1).bit_length()


def _reconstruct(factors, lam, idx: torch.Tensor) -> torch.Tensor:
    acc = lam[None, :].expand(idx.shape[0], lam.shape[0])
    for w, f in enumerate(factors):
        acc = acc * f.index_select(0, idx[:, w])
    return acc.sum(dim=1)


def _topk(factors, lam, coords: torch.Tensor, *, mode: int, k: int):
    wgt = lam[None, :].expand(coords.shape[0], lam.shape[0])
    for u, f in enumerate(factors):
        if u != mode:
            wgt = wgt * f.index_select(0, coords[:, u])
    scores = wgt @ factors[mode].T      # (B, I_mode)
    return torch.topk(scores, k, dim=1)


class ServingEngine:
    """Shape-bucketed query execution over one published
    :class:`FactorSnapshot`, on the snapshot's device."""

    def __init__(self, snapshot: FactorSnapshot, *,
                 metrics: ServiceMetrics | None = None,
                 max_batch: int = 1 << 15, min_bucket: int = 8):
        self.metrics = metrics or ServiceMetrics()
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self._publish_lock = threading.Lock()
        self._reconstruct_shapes: set[int] = set()
        self._topk_shapes: set[tuple] = set()
        self.snapshot = snapshot  # last: engine fully formed at publish
        self.metrics.set_gauge("snapshot_version", snapshot.version)

    # -- snapshot lifecycle ------------------------------------------------
    @property
    def version(self) -> int:
        return self.snapshot.version

    def publish(self, snapshot: FactorSnapshot) -> None:
        """Blue/green swap: validate geometry, then make ``snapshot`` the
        one new queries see. The swap is a single attribute assignment —
        in-flight queries finish on the snapshot they captured, readers
        never observe a half-published state or block."""
        with self._publish_lock:
            cur = self.snapshot
            if snapshot.shape != cur.shape or snapshot.rank != cur.rank:
                raise ValueError(
                    f"published snapshot geometry (shape {snapshot.shape}, "
                    f"rank {snapshot.rank}) does not match the serving "
                    f"geometry (shape {cur.shape}, rank {cur.rank}); a "
                    f"geometry change is a new engine, not a publish")
            if snapshot.version <= cur.version:
                raise ValueError(
                    f"published snapshot version {snapshot.version} must "
                    f"exceed the current version {cur.version}")
            self.snapshot = snapshot
        self.metrics.set_gauge("snapshot_version", snapshot.version)

    # -- queries -----------------------------------------------------------
    def reconstruct_batch(self, indices: np.ndarray) -> np.ndarray:
        """Model values at ``(k, nmodes)`` coordinates against the current
        snapshot — fp32 device math, numerically consistent with the
        float64 :meth:`CPResult.reconstruct_at` within fp32 tolerance.
        Bounds-checked per mode; any batch size (padded to a power-of-two
        bucket and, beyond ``max_batch``, chunked)."""
        snap = self.snapshot  # capture once: swap-immune for this query
        idx = validate_coords(indices, snap.shape)
        n = idx.shape[0]
        if n == 0:
            return np.empty(0, np.float32)
        if n > self.max_batch:
            return np.concatenate(
                [self.reconstruct_batch(idx[s:s + self.max_batch])
                 for s in range(0, n, self.max_batch)])
        with self.metrics.time("reconstruct"):
            b = _bucket(n, self.min_bucket)
            if b != n:  # pad with row 0 of every mode (always in range)
                idx = np.concatenate(
                    [idx, np.zeros((b - n, idx.shape[1]), np.int64)])
            self._reconstruct_shapes.add(b)
            self.metrics.set_gauge("reconstruct_buckets",
                                   len(self._reconstruct_shapes))
            out = _reconstruct(snap.factors, snap.lam,
                               torch.from_numpy(idx).to(snap.device))
            res = out.cpu().numpy()[:n]
        self.metrics.inc("queries_total")
        self.metrics.inc("reconstruct_rows", n)
        return res

    def topk_slice(self, fixed_coords: np.ndarray, mode: int, k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Top-``k`` indices of ``mode`` by reconstruction score with all
        other coordinates fixed. ``fixed_coords`` is ``(nmodes,)`` or a
        batch ``(B, nmodes)``; its ``mode`` column is ignored (pass
        anything, conventionally 0). Returns ``(scores, indices)``, each
        ``(k,)`` or ``(B, k)``, scores descending (``torch.topk`` may order
        exactly tied scores otherwise than the reference's
        ``lax.top_k``)."""
        snap = self.snapshot
        nmodes = len(snap.shape)
        if not 0 <= mode < nmodes:
            raise ValueError(f"mode {mode} out of range [0, {nmodes})")
        size = snap.shape[mode]
        if not 1 <= k <= size:
            raise ValueError(f"k={k} outside [1, {size}] for mode {mode} "
                             f"(size {size})")
        coords = np.asarray(fixed_coords)
        single = coords.ndim == 1
        if single:
            coords = coords[None, :]
        coords = np.array(coords, np.int64)
        coords[:, mode] = 0  # free mode: neutralize before bounds check
        coords = validate_coords(coords, snap.shape, what="fixed coordinate")
        with self.metrics.time("topk"):
            b = _bucket(coords.shape[0], self.min_bucket)
            if b != coords.shape[0]:
                pad = np.zeros((b - coords.shape[0], nmodes), np.int64)
                padded = np.concatenate([coords, pad])
            else:
                padded = coords
            kb = min(_bucket(k, 1), size)  # k bucketed too: few (mode, k)
            self._topk_shapes.add((b, int(mode), kb))
            self.metrics.set_gauge("topk_buckets", len(self._topk_shapes))
            scores, idx = _topk(snap.factors, snap.lam,
                                torch.from_numpy(padded).to(snap.device),
                                mode=int(mode), k=kb)
            scores = scores.cpu().numpy()[:coords.shape[0], :k]
            idx = idx.cpu().numpy()[:coords.shape[0], :k]
        self.metrics.inc("queries_total")
        self.metrics.inc("topk_rows", coords.shape[0])
        if single:
            return scores[0], idx[0]
        return scores, idx
