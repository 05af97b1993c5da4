"""Sparse tensor I/O and the paper's dataset profiles.

The port's copy of the reference package's ``sparse/io.py``:
``read_tns``/``write_tns`` handle the FROSTT ``.tns`` text format (1-based
coordinates, value last, transparently compressed when the path ends in
``.gz``), ``make_profile_tensor`` produces synthetic tensors whose shape
*ratios* and skew match the paper's four billion-scale datasets (Table 3),
scaled down, and ``make_lowrank_tensor`` a sparse tensor that is an exact
CP model. Tests hold each bitwise against the reference (``write_tns``
byte for byte).
"""
from __future__ import annotations

import dataclasses
import gzip
import itertools
from typing import Iterator

import numpy as np

from repro_torch.core.coo import SparseTensor, random_sparse

__all__ = ["read_tns", "write_tns", "iter_tns_batches", "DATASET_PROFILES",
           "DatasetProfile", "profile_geometry", "make_profile_tensor",
           "make_lowrank_tensor"]

# Lines parsed per batch. Each batch becomes two ndarray chunks immediately,
# so peak Python-object overhead is O(chunk_lines), not O(nnz).
READ_TNS_CHUNK_LINES = 1 << 20

# Nonzeros per np.savetxt call in write_tns: bounds the formatted-text
# working set without paying a Python-level loop per line.
WRITE_TNS_CHUNK = 1 << 18


def _open_text(path: str, mode: str = "rt"):
    """Open ``path`` as text, via ``gzip`` when the extension says so."""
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode.rstrip("t") or "r")


def iter_tns_batches(path: str, *, chunk_lines: int = READ_TNS_CHUNK_LINES
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream a ``.tns``/``.tns.gz`` file as ``(indices, values)`` batches.

    ``indices`` are 0-based int64 ``(k, nmodes)``, ``values`` float32
    ``(k,)``, with ``k <= chunk_lines``. ``#``/``%`` comment lines and blank
    lines are skipped anywhere.
    """
    ncols = None
    with _open_text(path) as f:
        for batch in iter(lambda: list(itertools.islice(f, chunk_lines)), []):
            arr = np.loadtxt(batch, dtype=np.float64, comments=("#", "%"),
                             ndmin=2)
            if arr.size == 0:
                continue  # batch was all comments/blanks
            if ncols is None:
                ncols = arr.shape[1]
                if ncols < 2:
                    raise ValueError(
                        f"{path}: a .tns line needs at least one coordinate "
                        f"and a value, got {ncols} column(s)")
            elif arr.shape[1] != ncols:
                raise ValueError(
                    f"{path}: inconsistent column count "
                    f"({arr.shape[1]} vs {ncols})")
            yield arr[:, :-1].astype(np.int64) - 1, arr[:, -1].astype(np.float32)


def read_tns(path: str, *, chunk_lines: int = READ_TNS_CHUNK_LINES
             ) -> SparseTensor:
    """Read a FROSTT ``.tns`` text file (1-based coordinates, value last);
    ``.gz`` paths are decompressed on the fly. Coordinates beyond int32
    raise a ``ValueError`` instead of wrapping around."""
    ind_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    for ind, val in iter_tns_batches(path, chunk_lines=chunk_lines):
        ind_chunks.append(ind)
        val_chunks.append(val)
    if not ind_chunks:
        raise ValueError(f"{path}: no nonzeros")
    ind = np.concatenate(ind_chunks)
    val = np.concatenate(val_chunks)
    max_index = int(ind.max()) if ind.size else 0
    if max_index > np.iinfo(np.int32).max:
        raise ValueError(
            f"{path}: coordinate {max_index + 1} overflows the in-memory "
            f"int32 index dtype")
    shape = tuple(int(s) for s in (ind.max(axis=0) + 1))
    return SparseTensor(ind.astype(np.int32), val, shape)


def write_tns(path: str, t: SparseTensor, *,
              chunk: int = WRITE_TNS_CHUNK) -> None:
    """Write ``t`` in ``.tns`` text (1-based, value last), gzip-compressed
    when ``path`` ends in ``.gz``. ``np.savetxt`` formats ``chunk`` nonzeros
    per call; ``%.9g`` round-trips every float32 value exactly."""
    fmt = " ".join(["%d"] * t.nmodes) + " %.9g"
    with _open_text(path, "wt") as f:
        for s in range(0, t.nnz, chunk):
            block = np.column_stack([
                t.indices[s:s + chunk].astype(np.float64) + 1,
                t.values[s:s + chunk].astype(np.float64)])
            np.savetxt(f, block, fmt=fmt)


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """Shape and nnz of a paper dataset (Table 3) plus its skew character."""

    name: str
    shape: tuple[int, ...]
    nnz: int
    distribution: str  # 'uniform' | 'zipf'
    zipf_a: float = 1.3


# Paper Table 3. Twitch is the skewed one (§5.5: popular streamers/games).
DATASET_PROFILES: dict[str, DatasetProfile] = {
    "amazon": DatasetProfile("amazon", (4_821_207, 1_774_269, 1_805_187), 1_741_809_018, "zipf", 1.1),
    "patents": DatasetProfile("patents", (46, 239_172, 239_172), 3_596_640_708, "uniform"),
    "reddit": DatasetProfile("reddit", (8_211_298, 176_962, 8_116_559), 4_687_474_081, "zipf", 1.05),
    "twitch": DatasetProfile("twitch", (15_524_309, 6_161_666, 783_865, 6_103, 6_103), 474_676_555, "zipf", 1.4),
}


def profile_geometry(name: str, scale: float) -> tuple[tuple[int, ...], int]:
    """(shape, nnz) of a paper dataset profile at the given linear scale."""
    p = DATASET_PROFILES[name]
    shape = tuple(max(8, int(round(s * scale))) for s in p.shape)
    nnz = max(64, int(round(p.nnz * scale)))
    return shape, nnz


def make_profile_tensor(name: str, *, scale: float = 1e-3, seed: int = 0) -> SparseTensor:
    """Synthetic stand-in for a paper dataset, linearly scaled.

    Mode sizes and nnz are multiplied by ``scale`` (min size 8 per mode) so the
    shape *ratios* — what drives partition balance — are preserved.
    """
    p = DATASET_PROFILES[name]
    shape, nnz = profile_geometry(name, scale)
    return random_sparse(
        shape, nnz, seed=seed, distribution=p.distribution, zipf_a=p.zipf_a)


def make_lowrank_tensor(shape, rank: int, nnz: int, *,
                        seed: int = 0) -> SparseTensor:
    """A sparse tensor that IS an exact CP model of the given rank.

    Each mode is split into ``rank`` contiguous segments; component ``r``
    is a (weighted) indicator of a random row subset of segment ``r`` in
    every mode, so the model is ``rank`` disjoint aligned blocks. The
    nonzeros enumerate every cell of every block (~``nnz`` total, subset
    sizes chosen per block), and nonzero order is shuffled. CP-ALS at the
    same rank converges to fit ≈ 1 from any reasonable start.
    """
    shape = tuple(int(s) for s in shape)
    nmodes = len(shape)
    if any(s < rank for s in shape):
        raise ValueError(f"every mode of {shape} must have >= rank={rank} "
                         f"rows (one segment per component)")
    rng = np.random.default_rng(seed)
    bounds = [np.linspace(0, s, rank + 1).astype(np.int64) for s in shape]
    # distinct per-component weights so components are distinguishable
    weights = np.linspace(0.5, 1.5, rank)
    cells_per = max(nnz // rank, 1)
    inds, vals = [], []
    for r in range(rank):
        seg_len = [int(bounds[d][r + 1] - bounds[d][r])
                   for d in range(nmodes)]
        m = [min(L, max(1, int(round(cells_per ** (1.0 / nmodes)))))
             for L in seg_len]
        # adjust the largest mode so the block lands near cells_per
        rest = int(np.prod(m[:-1]))
        m[-1] = min(seg_len[-1], max(1, int(round(cells_per / rest))))
        rows = [np.sort(rng.choice(seg_len[d], size=m[d], replace=False)
                        + bounds[d][r]) for d in range(nmodes)]
        grid = np.meshgrid(*rows, indexing="ij")
        block = np.stack([g.ravel() for g in grid], axis=1)
        inds.append(block)
        vals.append(np.full(block.shape[0], weights[r], np.float32))
    ind = np.concatenate(inds)
    val = np.concatenate(vals)
    order = rng.permutation(ind.shape[0])
    return SparseTensor(ind[order].astype(np.int32), val[order], shape)
