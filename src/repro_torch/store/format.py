"""On-disk layout of the out-of-core tensor store (format v1).

The port's copy of the reference package's ``store/format.py``.

A store is a directory::

    store/
      manifest.json      # shape/nnz/dtypes + per-chunk per-mode stats
      mode0.bin ...      # one packed little-endian index column per mode,
                         # dtype minimized per mode (<u2 / <u4 / <u8)
      values.bin         # packed <f4 values
      hist_mode0.bin ... # exact per-mode nnz histograms, <i8 — the
                         # "plan-from-stats" inputs (O(index space), read
                         # without touching any chunk data)

Chunking is logical: chunk ``k`` is nonzero rows ``[k*chunk_nnz,
min((k+1)*chunk_nnz, nnz))`` of every column file, so a chunk read is a
strided slice of an ``np.memmap`` — no per-chunk file handles, no framing
bytes. The manifest carries, per chunk and per mode, the min/max index range
(what lets shard materialization skip chunks that cannot contain a device's
rows) and a coarse binned histogram (skew diagnostics); the *exact*
histograms partitioning needs live in the binary sidecar files above.

Everything is little-endian on disk; the reader converts on big-endian
hosts (memmap with explicit ``<``-prefixed dtypes).
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = [
    "FORMAT_VERSION", "MANIFEST_NAME", "VALUES_NAME", "VALUE_DTYPE",
    "HIST_DTYPE", "DEFAULT_CHUNK_NNZ", "CHUNK_HIST_BINS", "index_dtype",
    "mode_data_name", "mode_hist_name", "manifest_digest", "load_manifest",
    "save_manifest", "StoreFormatError",
]

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
VALUES_NAME = "values.bin"
VALUE_DTYPE = "<f4"
HIST_DTYPE = "<i8"
DEFAULT_CHUNK_NNZ = 1 << 20
CHUNK_HIST_BINS = 32


class StoreFormatError(ValueError):
    """The directory is not a valid tensor store (or a later format)."""


def index_dtype(mode_size: int) -> str:
    """Minimal little-endian unsigned dtype holding indices in
    ``[0, mode_size)``."""
    if mode_size <= 1 << 16:
        return "<u2"
    if mode_size <= 1 << 32:
        return "<u4"
    return "<u8"


def mode_data_name(mode: int) -> str:
    return f"mode{mode}.bin"


def mode_hist_name(mode: int) -> str:
    return f"hist_mode{mode}.bin"


def manifest_digest(manifest: dict) -> str:
    """Content digest of the manifest (canonical JSON, the ``digest`` key
    itself excluded). Keys the plan cache: two stores with identical shape,
    nnz, dtypes and per-chunk stats share a digest; any ingest difference
    re-keys."""
    clean = {k: v for k, v in manifest.items() if k != "digest"}
    payload = json.dumps(clean, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def save_manifest(path: str, manifest: dict) -> None:
    manifest = dict(manifest)
    manifest["digest"] = manifest_digest(manifest)
    tmp = os.path.join(path, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))


def load_manifest(path: str) -> dict:
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise StoreFormatError(f"{path!r} is not a tensor store "
                               f"(no {MANIFEST_NAME})")
    with open(mpath) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise StoreFormatError(
            f"store at {path!r} has format {version}, this build reads "
            f"format {FORMAT_VERSION}")
    if manifest.get("digest") is None:
        raise StoreFormatError(
            f"store manifest at {path!r} has no digest; not written by "
            f"save_manifest (or stripped since)")
    if manifest["digest"] != manifest_digest(manifest):
        raise StoreFormatError(
            f"store manifest at {path!r} fails its digest check "
            f"(corrupted or hand-edited)")
    expect = {"shape", "nnz", "chunk_nnz", "index_dtypes", "chunks"}
    missing = expect - manifest.keys()
    if missing:
        raise StoreFormatError(
            f"store manifest at {path!r} is missing keys {sorted(missing)}")
    return manifest


def _expected_sizes(manifest: dict) -> dict[str, int]:
    """File name → expected byte size for every data/stats file."""
    nnz = int(manifest["nnz"])
    shape = manifest["shape"]
    sizes = {VALUES_NAME: nnz * np.dtype(VALUE_DTYPE).itemsize}
    for d, dt in enumerate(manifest["index_dtypes"]):
        sizes[mode_data_name(d)] = nnz * np.dtype(dt).itemsize
        sizes[mode_hist_name(d)] = int(shape[d]) * np.dtype(HIST_DTYPE).itemsize
    return sizes
