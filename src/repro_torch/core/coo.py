"""N-mode sparse tensors in COO format.

A copy of the reference package's ``core/coo.py``: the port keeps its own
host-side container so that it imports nothing of the reference. The
container is numpy-backed (preprocessing, like the paper's host CPU, happens
off-device); :mod:`repro_torch.core.partition` turns it into per-mode shards
and :mod:`repro_torch.core.mttkrp` places them on a torch device. Tests hold
every function here bitwise against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["SparseTensor", "random_sparse", "draw_sparse_block",
           "from_dense", "to_dense"]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """An N-mode sparse tensor: ``indices[k]`` are the mode coordinates of
    nonzero ``values[k]``.

    indices: int32 (nnz, nmodes); values: float32 (nnz,); shape: per-mode sizes.
    Duplicates are allowed (they accumulate, as in standard COO semantics).
    """

    indices: np.ndarray
    values: np.ndarray
    shape: tuple[int, ...]

    def __post_init__(self):
        ind = np.asarray(self.indices)
        val = np.asarray(self.values)
        if ind.ndim != 2:
            raise ValueError(f"indices must be (nnz, nmodes), got {ind.shape}")
        if val.ndim != 1 or val.shape[0] != ind.shape[0]:
            raise ValueError("values must be (nnz,) aligned with indices")
        if ind.shape[1] != len(self.shape):
            raise ValueError(
                f"indices has {ind.shape[1]} modes, shape has {len(self.shape)}")
        object.__setattr__(self, "indices", np.ascontiguousarray(ind, np.int32))
        object.__setattr__(self, "values", np.ascontiguousarray(val, np.float32))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if self.nnz and (self.indices.min(axis=0) < 0).any():
            raise ValueError("negative index")
        if self.nnz and (self.indices.max(axis=0) >= np.array(self.shape)).any():
            raise ValueError("index out of range for shape")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    def norm(self) -> float:
        """Frobenius norm. Assumes no duplicate coordinates."""
        return float(np.sqrt((self.values.astype(np.float64) ** 2).sum()))

    def mode_histogram(self, mode: int) -> np.ndarray:
        """nnz count per index of ``mode`` (the partitioner's cost model)."""
        return np.bincount(self.indices[:, mode], minlength=self.shape[mode])

    def permuted(self, perm: np.ndarray) -> "SparseTensor":
        return SparseTensor(self.indices[perm], self.values[perm], self.shape)

    def sorted_by_mode(self, mode: int) -> "SparseTensor":
        """Stable sort of nonzeros by the given mode index (the FLYCOO-style
        per-mode tensor copy, minus the in-element shard ids the paper drops)."""
        return self.permuted(np.argsort(self.indices[:, mode], kind="stable"))

    def deduplicated(self) -> "SparseTensor":
        """Accumulate duplicate coordinates into single entries."""
        if self.nnz == 0:
            return self
        flat = np.ravel_multi_index(self.indices.T, self.shape)
        uniq, inv = np.unique(flat, return_inverse=True)
        vals = np.zeros(uniq.shape[0], np.float64)
        np.add.at(vals, inv, self.values)
        ind = np.stack(np.unravel_index(uniq, self.shape), axis=1)
        return SparseTensor(ind.astype(np.int32), vals.astype(np.float32), self.shape)


def from_dense(dense: np.ndarray, tol: float = 0.0) -> SparseTensor:
    mask = np.abs(dense) > tol
    ind = np.argwhere(mask).astype(np.int32)
    return SparseTensor(ind, dense[mask].astype(np.float32), dense.shape)


def to_dense(t: SparseTensor) -> np.ndarray:
    out = np.zeros(t.shape, np.float32)
    np.add.at(out, tuple(t.indices.T), t.values)
    return out


def draw_sparse_block(rng: np.random.Generator, shape: Sequence[int],
                      k: int, *, distribution: str = "uniform",
                      zipf_a: float = 1.3
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``k`` synthetic nonzeros: 0-based int64 indices ``(k, nmodes)``
    and float32 values. The single source of the per-mode distributions —
    :func:`random_sparse` is one full-size draw of this.

    ``distribution='zipf'`` skews nonzeros toward low indices per mode, the
    "popular streamers/games" effect the paper observes on Twitch (§5.5).
    """
    cols = []
    for s in shape:
        if distribution == "uniform":
            cols.append(rng.integers(0, s, size=k, dtype=np.int64))
        elif distribution == "zipf":
            # Zipf over [1, inf); fold into [0, s) to keep heavy head.
            z = rng.zipf(zipf_a, size=k) - 1
            cols.append(np.minimum(z, s - 1).astype(np.int64))
        else:
            raise ValueError(f"unknown distribution {distribution!r}")
    ind = np.stack(cols, axis=1)
    val = rng.standard_normal(k).astype(np.float32)
    return ind, val


def random_sparse(
    shape: Sequence[int],
    nnz: int,
    *,
    seed: int = 0,
    distribution: str = "uniform",
    zipf_a: float = 1.3,
    dedup: bool = True,
) -> SparseTensor:
    """Synthetic sparse tensor (see :func:`draw_sparse_block` for the
    per-mode distributions)."""
    rng = np.random.default_rng(seed)
    ind, val = draw_sparse_block(rng, shape, nnz, distribution=distribution,
                                 zipf_a=zipf_a)
    t = SparseTensor(ind.astype(np.int32), val, tuple(shape))
    return t.deduplicated() if dedup else t
