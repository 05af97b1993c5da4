"""Streaming ingest into the chunked binary tensor store.

The port's copy of the reference package's ``store/writer.py``: the same
bytes on disk, so each package reads the other's stores.

:class:`StoreWriter` is the single sink every ingest path feeds: it accepts
nonzeros in arbitrary-sized batches, re-chunks them into fixed ``chunk_nnz``
logical chunks, packs index columns with per-mode minimized dtypes, and
accumulates every statistic the manifest carries — per-chunk per-mode
min/max and binned histograms, the exact per-mode histograms (the
plan-from-stats inputs), and the Frobenius norm accumulator. Peak memory is
O(chunk_nnz + index space); the full COO never exists.

On top of it:

* :func:`convert_tns` — the two-pass ``.tns``/``.tns.gz`` converter. Pass 1
  streams the text once to learn the shape (which fixes the per-mode index
  dtypes); pass 2 streams again and writes.
* :func:`write_store_from_coo` — spill an in-memory :class:`SparseTensor`.
* :func:`write_profile_store` — the store-native synthetic generator:
  writes a ``DATASET_PROFILES`` tensor chunk-by-chunk at any scale (paper
  scale included) without ever materializing a COO.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.core.coo import SparseTensor, draw_sparse_block
from repro_torch.sparse.io import (DATASET_PROFILES, iter_tns_batches,
                                   profile_geometry)
from repro_torch.store import format as fmt

__all__ = ["StoreWriter", "append_to_store", "convert_tns",
           "write_store_from_coo", "write_profile_store"]


def _chunk_stats(ind: np.ndarray, shape: tuple[int, ...],
                 bins: int) -> dict:
    """Per-chunk manifest stats for one chunk's ``(k, nmodes)`` indices:
    per-mode min/max plus the coarse fixed-bin histogram."""
    stats = {"nnz": int(ind.shape[0]), "min": [], "max": [], "hist": []}
    for d, size in enumerate(shape):
        col = ind[:, d]
        stats["min"].append(int(col.min()))
        stats["max"].append(int(col.max()))
        edges = np.linspace(0, size, bins + 1)
        bh, _ = np.histogram(col, bins=edges)
        stats["hist"].append([int(x) for x in bh])
    return stats


class StoreWriter:
    """Streaming writer for one tensor store directory.

    The nonzero *order* on disk is exactly the append order — partition
    materialization relies on it to reproduce the in-memory path's stable
    sort bit-for-bit.
    """

    def __init__(self, path: str, shape, *,
                 chunk_nnz: int = fmt.DEFAULT_CHUNK_NNZ,
                 hist_bins: int = fmt.CHUNK_HIST_BINS):
        if chunk_nnz < 1:
            raise ValueError("chunk_nnz must be >= 1")
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        if any(s < 1 for s in self.shape):
            raise ValueError(f"every mode size must be >= 1, got {self.shape}")
        self.nmodes = len(self.shape)
        self.chunk_nnz = int(chunk_nnz)
        self.hist_bins = int(hist_bins)
        self.index_dtypes = [fmt.index_dtype(s) for s in self.shape]
        os.makedirs(path, exist_ok=True)
        self._mode_files = [open(os.path.join(path, fmt.mode_data_name(d)),
                                 "wb") for d in range(self.nmodes)]
        self._val_file = open(os.path.join(path, fmt.VALUES_NAME), "wb")
        self._hists = [np.zeros(s, np.int64) for s in self.shape]
        self._values_sumsq = 0.0
        self._chunks: list[dict] = []
        self._nnz = 0
        # re-chunking buffer: batches accumulate here until a full chunk
        self._buf_ind: list[np.ndarray] = []
        self._buf_val: list[np.ndarray] = []
        self._buffered = 0
        self._closed = False
        self._manifest: dict | None = None  # set by close(); None if aborted

    # -- ingest ------------------------------------------------------------
    def append(self, indices: np.ndarray, values: np.ndarray) -> None:
        """Append a batch of nonzeros (0-based ``(k, nmodes)`` indices,
        ``(k,)`` values), any ``k``. Batches are re-chunked internally."""
        if self._closed:
            raise RuntimeError("StoreWriter is closed")
        ind = np.asarray(indices)
        val = np.asarray(values, np.float32)
        if ind.ndim != 2 or ind.shape[1] != self.nmodes:
            raise ValueError(f"indices must be (k, {self.nmodes}), "
                             f"got {ind.shape}")
        if val.shape != (ind.shape[0],):
            raise ValueError("values must align with indices")
        if ind.size:
            ind = ind.astype(np.int64, copy=False)
            if int(ind.min()) < 0:
                raise ValueError("negative index")
            mx = ind.max(axis=0)
            if (mx >= np.asarray(self.shape)).any():
                raise ValueError(
                    f"index out of range for shape {self.shape}: "
                    f"per-mode max {tuple(int(x) for x in mx)}")
        self._buf_ind.append(ind)
        self._buf_val.append(val)
        self._buffered += ind.shape[0]
        while self._buffered >= self.chunk_nnz:
            self._flush_chunk(self.chunk_nnz)

    def _take(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Pop exactly ``k`` buffered nonzeros (caller guarantees supply)."""
        got_i, got_v, need = [], [], k
        while need:
            ind, val = self._buf_ind[0], self._buf_val[0]
            if ind.shape[0] <= need:
                self._buf_ind.pop(0)
                self._buf_val.pop(0)
                got_i.append(ind)
                got_v.append(val)
                need -= ind.shape[0]
            else:
                got_i.append(ind[:need])
                got_v.append(val[:need])
                self._buf_ind[0] = ind[need:]
                self._buf_val[0] = val[need:]
                need = 0
        self._buffered -= k
        if len(got_i) == 1:
            return got_i[0], got_v[0]
        return np.concatenate(got_i), np.concatenate(got_v)

    def _flush_chunk(self, k: int) -> None:
        ind, val = self._take(k)
        # coarse fixed-bin per-chunk histogram: skew at a glance without
        # the exact sidecar
        stats = _chunk_stats(ind, self.shape, self.hist_bins)
        for d in range(self.nmodes):
            col = ind[:, d]
            self._mode_files[d].write(
                np.ascontiguousarray(col.astype(self.index_dtypes[d])
                                     ).tobytes())
            np.add.at(self._hists[d], col, 1)
        self._val_file.write(np.ascontiguousarray(
            val.astype(fmt.VALUE_DTYPE)).tobytes())
        self._values_sumsq += float((val.astype(np.float64) ** 2).sum())
        self._chunks.append(stats)
        self._nnz += k

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> dict:
        """Flush the partial tail chunk, write histogram sidecars and the
        manifest. Returns the manifest. Idempotent."""
        if self._closed:
            return self._manifest
        if self._buffered:
            self._flush_chunk(self._buffered)
        if self._nnz == 0:
            raise ValueError("refusing to write an empty store (no nonzeros)")
        for f in self._mode_files:
            f.flush()
            os.fsync(f.fileno())
            f.close()
        self._val_file.flush()
        os.fsync(self._val_file.fileno())
        self._val_file.close()
        for d, h in enumerate(self._hists):
            with open(os.path.join(self.path, fmt.mode_hist_name(d)),
                      "wb") as f:
                f.write(np.ascontiguousarray(
                    h.astype(fmt.HIST_DTYPE)).tobytes())
        self._manifest = {
            "format_version": fmt.FORMAT_VERSION,
            "shape": list(self.shape),
            "nnz": int(self._nnz),
            "chunk_nnz": int(self.chunk_nnz),
            "index_dtypes": list(self.index_dtypes),
            "value_dtype": fmt.VALUE_DTYPE,
            "hist_dtype": fmt.HIST_DTYPE,
            "hist_bins": int(self.hist_bins),
            "values_sumsq": self._values_sumsq,
            "chunks": self._chunks,
        }
        fmt.save_manifest(self.path, self._manifest)
        self._closed = True
        return self._manifest

    def abort(self) -> None:
        """Close file handles without writing a manifest — the directory is
        left an invalid store (no manifest), which readers reject."""
        if self._closed:
            return
        self._closed = True
        for f in self._mode_files + [self._val_file]:
            try:
                f.close()
            except OSError:
                pass

    def __enter__(self) -> "StoreWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


# -- in-place growth ------------------------------------------------------

def append_to_store(path: str, indices: np.ndarray,
                    values: np.ndarray) -> dict:
    """Append nonzeros to an EXISTING store in place (the growing-tensor
    ingest path serving refreshes against).

    The data files grow by plain byte appends; the partial tail chunk (if
    any) absorbs the first new rows, so its manifest stats are recomputed
    from the old tail plus the new batch. Exact histogram sidecars and the
    Frobenius accumulator are updated incrementally; the manifest (with a
    fresh digest) is written LAST — so :meth:`TensorStore.refresh` on a
    live reader sees either the old store or the complete new one.

    Not crash-atomic the way a fresh :class:`StoreWriter` is: a crash
    after the byte appends but before the manifest rename leaves data
    files longer than the manifest implies, which the reader's size check
    rejects as a stale store (re-ingest to recover). Returns the updated
    manifest.
    """
    manifest = fmt.load_manifest(path)
    shape = tuple(int(s) for s in manifest["shape"])
    nmodes = len(shape)
    chunk_nnz = int(manifest["chunk_nnz"])
    bins = int(manifest.get("hist_bins", fmt.CHUNK_HIST_BINS))
    hist_dtype = manifest.get("hist_dtype", fmt.HIST_DTYPE)

    ind = np.asarray(indices)
    val = np.asarray(values, np.float32)
    if ind.ndim != 2 or ind.shape[1] != nmodes:
        raise ValueError(f"indices must be (k, {nmodes}), got {ind.shape}")
    if val.shape != (ind.shape[0],):
        raise ValueError("values must align with indices")
    if ind.shape[0] == 0:
        return manifest
    ind = ind.astype(np.int64, copy=False)
    if int(ind.min()) < 0:
        raise ValueError("negative index")
    mx = ind.max(axis=0)
    if (mx >= np.asarray(shape)).any():
        raise ValueError(f"index out of range for shape {shape}: "
                         f"per-mode max {tuple(int(x) for x in mx)}")

    old_nnz = int(manifest["nnz"])
    rem = old_nnz % chunk_nnz
    first_changed = old_nnz // chunk_nnz  # == full-chunk count either way

    # the partial tail chunk's rows re-enter stat computation
    if rem:
        tail_ind = np.empty((rem, nmodes), np.int64)
        for d in range(nmodes):
            col = np.memmap(os.path.join(path, fmt.mode_data_name(d)),
                            dtype=manifest["index_dtypes"][d], mode="r")
            tail_ind[:, d] = col[old_nnz - rem:old_nnz]
            del col
        stat_ind = np.concatenate([tail_ind, ind])
    else:
        stat_ind = ind

    for d in range(nmodes):
        with open(os.path.join(path, fmt.mode_data_name(d)), "ab") as f:
            f.write(np.ascontiguousarray(
                ind[:, d].astype(manifest["index_dtypes"][d])).tobytes())
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(path, fmt.VALUES_NAME), "ab") as f:
        f.write(np.ascontiguousarray(val.astype(
            manifest.get("value_dtype", fmt.VALUE_DTYPE))).tobytes())
        f.flush()
        os.fsync(f.fileno())

    # exact per-mode histograms: += new rows only (tail already counted);
    # written atomically so a concurrent reader never maps a torn sidecar
    for d in range(nmodes):
        hpath = os.path.join(path, fmt.mode_hist_name(d))
        h = np.fromfile(hpath, dtype=hist_dtype).astype(np.int64)
        np.add.at(h, ind[:, d], 1)
        tmp = hpath + ".tmp"
        with open(tmp, "wb") as f:
            f.write(np.ascontiguousarray(h.astype(hist_dtype)).tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, hpath)

    chunks = list(manifest["chunks"][:first_changed])
    for s in range(0, stat_ind.shape[0], chunk_nnz):
        chunks.append(_chunk_stats(stat_ind[s:s + chunk_nnz], shape, bins))

    new_manifest = dict(manifest)
    new_manifest.pop("digest", None)
    new_manifest["nnz"] = old_nnz + int(ind.shape[0])
    new_manifest["chunks"] = chunks
    new_manifest["values_sumsq"] = float(manifest["values_sumsq"]) + \
        float((val.astype(np.float64) ** 2).sum())
    fmt.save_manifest(path, new_manifest)
    return fmt.load_manifest(path)


# -- converters ----------------------------------------------------------

def convert_tns(tns_path: str, store_path: str, *,
                chunk_nnz: int = fmt.DEFAULT_CHUNK_NNZ,
                chunk_lines: int | None = None,
                shape: tuple[int, ...] | None = None) -> dict:
    """Two-pass streaming ``.tns``/``.tns.gz`` → store conversion.

    Pass 1 streams the text to learn the shape (per-mode max coordinate),
    which fixes the minimized index dtypes; pass 2 streams again and packs.
    Pass ``shape`` to skip pass 1 when the geometry is already known (e.g.
    from a FROSTT header file). Peak memory is O(chunk_lines + index space).
    Returns the conversion report: the manifest plus ``elapsed_s`` and
    ``nnz_per_s`` throughput.
    """
    kw = {} if chunk_lines is None else {"chunk_lines": chunk_lines}
    t0 = time.perf_counter()
    if shape is None:
        mx = None
        for ind, _ in iter_tns_batches(tns_path, **kw):
            bmx = ind.max(axis=0)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        if mx is None:
            raise ValueError(f"{tns_path}: no nonzeros")
        shape = tuple(int(x) + 1 for x in mx)
    with StoreWriter(store_path, shape, chunk_nnz=chunk_nnz) as w:
        for ind, val in iter_tns_batches(tns_path, **kw):
            w.append(ind, val)
    manifest = w.close()
    elapsed = time.perf_counter() - t0
    return dict(manifest, elapsed_s=elapsed,
                nnz_per_s=manifest["nnz"] / max(elapsed, 1e-9))


def write_store_from_coo(t: SparseTensor, store_path: str, *,
                         chunk_nnz: int = fmt.DEFAULT_CHUNK_NNZ) -> dict:
    """Spill an in-memory COO tensor to a store (nonzero order preserved)."""
    with StoreWriter(store_path, t.shape, chunk_nnz=chunk_nnz) as w:
        for s in range(0, t.nnz, chunk_nnz):
            w.append(t.indices[s:s + chunk_nnz].astype(np.int64),
                     t.values[s:s + chunk_nnz])
    return w.close()


def write_profile_store(name: str, store_path: str, *, scale: float = 1.0,
                        seed: int = 0,
                        chunk_nnz: int = fmt.DEFAULT_CHUNK_NNZ) -> dict:
    """Store-native synthetic generator for a paper dataset profile.

    Draws and writes ``chunk_nnz`` nonzeros at a time — at ``scale=1.0``
    this produces the paper's billion-nonzero geometries with O(chunk)
    host memory, which no COO-first path can do. Deterministic in
    ``(name, scale, seed, chunk_nnz)``.

    Unlike :func:`repro_torch.core.coo.random_sparse` the output keeps duplicate
    coordinates (deduplication is a host-RAM-sized sort by nature; MTTKRP
    accumulates duplicates correctly). One caveat follows: the manifest's
    Frobenius accumulator is ``Σv²``, while the accumulated tensor's true
    norm term at a duplicated cell is ``(Σv)²`` — so on heavily skewed
    zipf profiles the reported ALS *fit* (which normalizes by ``‖X‖``) is
    systematically offset. Factors and convergence behaviour are
    unaffected; for fit-exact comparisons, ingest a deduplicated tensor
    (``write_store_from_coo(random_sparse(...))`` or a real ``.tns``).
    """
    p = DATASET_PROFILES[name]
    shape, nnz = profile_geometry(name, scale)
    rng = np.random.default_rng(seed)
    with StoreWriter(store_path, shape, chunk_nnz=chunk_nnz) as w:
        left = nnz
        while left:
            k = min(left, chunk_nnz)
            ind, val = draw_sparse_block(rng, shape, k,
                                         distribution=p.distribution,
                                         zipf_a=p.zipf_a)
            w.append(ind, val)
            left -= k
    return w.close()
