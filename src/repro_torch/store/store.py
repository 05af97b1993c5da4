"""Read side of the out-of-core tensor store.

The port's copy of the reference package's ``store/store.py``.

:class:`TensorStore` presents the :class:`~repro_torch.core.coo.SparseTensor`-
compatible surface the rest of the stack consumes — ``shape``, ``nnz``,
``nmodes``, ``norm()``, ``mode_histogram()`` — while keeping the nonzeros on
disk behind ``np.memmap``. Statistics queries (histograms, norm, per-chunk
ranges) never touch chunk data; chunk reads are explicit
(:meth:`read_chunk` / :meth:`iter_chunks` / :meth:`slice_for_device`) and
counted in :attr:`access_stats`, which is how tests assert that planning is
stats-only and that shard materialization skips non-overlapping chunks.
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from repro_torch.store import format as fmt

__all__ = ["TensorStore"]


class TensorStore:
    """A chunked, mmap-backed sparse tensor (format v1; see
    :mod:`repro_torch.store.format`)."""

    def __init__(self, path: str):
        self.path = path
        self._bind(fmt.load_manifest(path))
        self.access_stats = {"chunk_reads": 0, "nnz_read": 0, "hist_reads": 0}

    def _bind(self, manifest: dict) -> None:
        """(Re)bind memmaps and cached stats to ``manifest`` — the shared
        body of ``__init__`` and :meth:`refresh`."""
        path = self.path
        self.manifest = manifest
        m = self.manifest
        self.shape: tuple[int, ...] = tuple(int(s) for s in m["shape"])
        self.nnz: int = int(m["nnz"])
        self.chunk_nnz: int = int(m["chunk_nnz"])
        self.index_dtypes: list[str] = list(m["index_dtypes"])
        self.digest: str = m["digest"]
        sizes = fmt._expected_sizes(m)
        for name, expect in sizes.items():
            fpath = os.path.join(path, name)
            if not os.path.exists(fpath):
                raise fmt.StoreFormatError(f"store at {path!r} is missing "
                                           f"{name}")
            got = os.path.getsize(fpath)
            if got != expect:
                raise fmt.StoreFormatError(
                    f"store file {name} has {got} bytes, manifest implies "
                    f"{expect} (truncated or stale store)")
        self._cols = [np.memmap(os.path.join(path, fmt.mode_data_name(d)),
                                dtype=self.index_dtypes[d], mode="r")
                      for d in range(self.nmodes)]
        self._vals = np.memmap(os.path.join(path, fmt.VALUES_NAME),
                               dtype=m.get("value_dtype", fmt.VALUE_DTYPE),
                               mode="r")
        self._hists = [np.memmap(os.path.join(path, fmt.mode_hist_name(d)),
                                 dtype=m.get("hist_dtype", fmt.HIST_DTYPE),
                                 mode="r")
                       for d in range(self.nmodes)]
        # per-chunk per-mode index ranges, (num_chunks, nmodes) int64
        self.chunk_min = np.array([c["min"] for c in m["chunks"]], np.int64
                                  ).reshape(self.num_chunks, self.nmodes)
        self.chunk_max = np.array([c["max"] for c in m["chunks"]], np.int64
                                  ).reshape(self.num_chunks, self.nmodes)

    # -- growth ------------------------------------------------------------
    def refresh(self) -> dict | None:
        """Pick up an in-place append (:func:`repro_torch.store.append_to_store`).

        Re-reads the manifest; returns ``None`` when the digest is
        unchanged (no-op, memmaps untouched). When the store grew, rebinds
        every memmap and cached stat to the new manifest and returns the
        delta a refresher needs::

            {"old_nnz", "new_nnz", "appended_nnz",
             "old_digest", "new_digest",
             "first_changed_chunk",   # chunks >= this index are new/re-stat
             "old_num_chunks", "new_num_chunks"}

        Raises :class:`~repro_torch.store.format.StoreFormatError` if the
        manifest changed in any way other than an append (shape, chunking
        or dtypes differ, or nnz shrank) — that is a rewritten store, and
        a reader holding derived state (plans, snapshots) must not
        silently adopt it."""
        manifest = fmt.load_manifest(self.path)
        if manifest["digest"] == self.digest:
            return None
        if tuple(int(s) for s in manifest["shape"]) != self.shape:
            raise fmt.StoreFormatError(
                f"store at {self.path!r} changed shape "
                f"{self.shape} -> {tuple(manifest['shape'])}; refresh() "
                f"only follows appends — reopen a new TensorStore")
        if int(manifest["chunk_nnz"]) != self.chunk_nnz or \
                list(manifest["index_dtypes"]) != self.index_dtypes:
            raise fmt.StoreFormatError(
                f"store at {self.path!r} changed chunking/dtypes under a "
                f"live reader; refresh() only follows appends")
        if int(manifest["nnz"]) < self.nnz:
            raise fmt.StoreFormatError(
                f"store at {self.path!r} shrank ({self.nnz} -> "
                f"{manifest['nnz']} nnz); refresh() only follows appends")
        old_nnz, old_digest = self.nnz, self.digest
        old_chunks = self.num_chunks
        self._bind(manifest)
        return {
            "old_nnz": old_nnz,
            "new_nnz": self.nnz,
            "appended_nnz": self.nnz - old_nnz,
            "old_digest": old_digest,
            "new_digest": self.digest,
            # floor(old_nnz / chunk_nnz): the partial tail chunk when one
            # existed, else the first brand-new chunk
            "first_changed_chunk": old_nnz // self.chunk_nnz,
            "old_num_chunks": old_chunks,
            "new_num_chunks": self.num_chunks,
        }

    def appended_mode_rows(self, old_nnz: int) -> list[np.ndarray]:
        """Per-mode sorted unique global indices appearing in rows
        ``[old_nnz, nnz)`` — the rows an incremental refit must re-solve
        (every other row's dense normal equations are unchanged up to the
        appended rows' contributions to the Gram matrices). O(appended)
        read, counted in :attr:`access_stats`."""
        if not 0 <= old_nnz <= self.nnz:
            raise ValueError(f"old_nnz {old_nnz} outside [0, {self.nnz}]")
        out = []
        for d in range(self.nmodes):
            out.append(np.unique(
                np.asarray(self._cols[d][old_nnz:self.nnz], np.int64)))
        self.access_stats["nnz_read"] += (self.nnz - old_nnz) * self.nmodes
        return out

    # -- SparseTensor-compatible surface ----------------------------------
    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def num_chunks(self) -> int:
        return len(self.manifest["chunks"])

    def norm(self) -> float:
        """Frobenius norm, from the manifest's sum-of-squares accumulator
        (assumes no duplicate coordinates, like the in-memory container)."""
        return float(np.sqrt(self.manifest["values_sumsq"]))

    def mode_histogram(self, mode: int) -> np.ndarray:
        """Exact nnz count per index of ``mode`` — read from the binary
        stats sidecar, O(index space), no chunk data touched."""
        self.access_stats["hist_reads"] += 1
        # np.array (not asarray): when the sidecar dtype is already int64,
        # asarray returns a view that pins the np.memmap handle open
        return np.array(self._hists[mode], np.int64)

    def reset_access_stats(self) -> None:
        self.access_stats = {"chunk_reads": 0, "nnz_read": 0,
                             "hist_reads": 0}

    # -- chunk access ------------------------------------------------------
    def chunk_bounds(self, chunk: int) -> tuple[int, int]:
        lo = chunk * self.chunk_nnz
        return lo, min(lo + self.chunk_nnz, self.nnz)

    def read_chunk(self, chunk: int) -> tuple[np.ndarray, np.ndarray]:
        """Nonzeros of one chunk: 0-based int64 ``(k, nmodes)`` indices and
        float32 ``(k,)`` values (host copies, chunk-bounded memory)."""
        if not 0 <= chunk < self.num_chunks:
            raise IndexError(f"chunk {chunk} out of range "
                             f"[0, {self.num_chunks})")
        lo, hi = self.chunk_bounds(chunk)
        ind = np.empty((hi - lo, self.nmodes), np.int64)
        for d in range(self.nmodes):
            ind[:, d] = self._cols[d][lo:hi]
        # np.array (not asarray): same-dtype asarray returns a view that
        # pins the np.memmap open — callers would accumulate one mapped
        # handle per chunk across a streamed sweep
        val = np.array(self._vals[lo:hi], np.float32)
        self.access_stats["chunk_reads"] += 1
        self.access_stats["nnz_read"] += hi - lo
        return ind, val

    def iter_chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Stream every chunk in file order (the order ingest appended —
        partition materialization depends on it)."""
        for k in range(self.num_chunks):
            yield self.read_chunk(k)

    def chunks_overlapping(self, mode: int, lo: int, hi: int) -> list[int]:
        """Chunks whose ``mode`` index range intersects ``[lo, hi]`` —
        a manifest-stats query (no data read). Conservative: a returned
        chunk *may* contain matching entries; a skipped one cannot."""
        keep = (self.chunk_max[:, mode] >= lo) & (self.chunk_min[:, mode] <= hi)
        return [int(k) for k in np.flatnonzero(keep)]

    def slice_for_device(self, mode: int, lo: int, hi: int
                         ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Stream only the nonzeros whose ``mode`` coordinate falls in
        ``[lo, hi]`` (a device's owned index range), in file order, reading
        only chunks that can overlap it."""
        for k in self.chunks_overlapping(mode, lo, hi):
            ind, val = self.read_chunk(k)
            keep = (ind[:, mode] >= lo) & (ind[:, mode] <= hi)
            if keep.any():
                yield ind[keep], val[keep]

    # -- convenience -------------------------------------------------------
    def to_coo(self):
        """Materialize the full tensor as an in-memory
        :class:`SparseTensor`. O(nnz) host RAM — small stores and tests
        only; raises when indices exceed the in-memory int32 dtype."""
        from repro_torch.core.coo import SparseTensor
        inds, vals = [], []
        for ind, val in self.iter_chunks():
            inds.append(ind)
            vals.append(val)
        ind = np.concatenate(inds)
        if ind.size and int(ind.max()) > np.iinfo(np.int32).max:
            raise ValueError(
                f"store at {self.path!r} has indices beyond int32; it "
                f"cannot round-trip through the in-memory SparseTensor")
        return SparseTensor(ind.astype(np.int32), np.concatenate(vals),
                            self.shape)

    def __repr__(self) -> str:
        return (f"TensorStore(path={self.path!r}, shape={self.shape}, "
                f"nnz={self.nnz}, chunks={self.num_chunks}"
                f"x{self.chunk_nnz})")
