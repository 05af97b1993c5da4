"""Chunk-size autotuner for the ``overlap`` exchange variant.

The counterpart of the reference package's ``comm/autotune.py``. The
overlap gather's one launch parameter is the row-chunk size: too coarse and
there is nothing to pipeline, too fine and per-copy overhead dominates. The
tuner times a handful of chunk counts on the *actual* :class:`CPMesh` with
synthetic payloads and caches the winner in the EC autotuner's file
(:mod:`repro_torch.kernels.autotune`, the port's own; keys ``xchg_...``, as
the reference's).

Timing: on one card, CUDA events around the gather (one warm-up, then the
best of ``repeats``); across several cards, the host clock with every card
synchronised before and after; on the CPU, the host clock. The tuning
copies are not counted as exchange traffic (``comm.volume``'s counts are
restored after). An entry is reused only when its candidate grid matches
the requested one.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.comm import collectives, volume
from repro_torch.kernels import autotune as ec_autotune

__all__ = ["autotune_chunk_rows", "DEFAULT_NUM_CHUNK_CANDIDATES"]

DEFAULT_NUM_CHUNK_CANDIDATES = (1, 2, 4, 8)

_MEMO: dict[str, tuple[dict, int]] = {}  # key -> (grid, winning chunk_rows)


def _cache_key(rows: int, rank: int, m: int, wire: str, backend: str) -> str:
    return f"xchg_overlap_rows{rows}_r{rank}_m{m}_{wire}_{backend}"


def _candidates(rows: int, num_chunks) -> list[int]:
    out = []
    for c in num_chunks:
        cr = max(1, -(-rows // int(c)))
        if cr not in out:
            out.append(cr)
    return out


def _time_chunk(rows: int, rank: int, mesh, all_axes, chunk_rows: int,
                wire_dtype, repeats: int, seed: int = 0) -> float:
    """Seconds of the best of ``repeats`` overlap gathers of ``rows`` rows
    per logical device, after one warm-up."""
    m = collectives.axis_size(mesh, all_axes)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m * rows, rank)).astype(np.float32)
    xs = [torch.from_numpy(x[k * rows:(k + 1) * rows]).to(d)
          for k, d in enumerate(mesh.devices)]
    wire = None if wire_dtype in (None, "float32") else \
        getattr(torch, wire_dtype)

    def gather():
        return collectives.overlap_all_gather(xs, mesh, all_axes,
                                              chunk_rows=chunk_rows,
                                              wire_dtype=wire)

    cards = sorted({d.index for d in mesh.devices if d.type == "cuda"})

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    gather()
    sync()
    best = float("inf")
    for _ in range(repeats):
        if len(cards) == 1:
            with torch.cuda.device(cards[0]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                gather()
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            gather()
            sync()
            best = min(best, time.perf_counter() - t0)
    return best


def autotune_chunk_rows(
    rows: int,
    rank: int,
    mesh,
    *,
    all_axes=("group", "sub"),
    wire_dtype: str | None = None,
    num_chunks=DEFAULT_NUM_CHUNK_CANDIDATES,
    repeats: int = 3,
    force: bool = False,
) -> int:
    """Sweep overlap chunk sizes on ``mesh``; return (and cache) the fastest
    ``chunk_rows`` for ``(rows, rank, devices, wire, backend)``. On a single
    device the gather is an identity: the default chunking is returned
    without timing or caching."""
    m = collectives.axis_size(mesh, all_axes)
    if m == 1:
        return collectives.default_chunk_rows(rows)
    wire = wire_dtype or "float32"
    backend = ec_autotune.backend_tag(mesh.devices[0])
    key = _cache_key(rows, rank, m, wire, backend)
    cands = _candidates(rows, num_chunks)
    grid = {"rows": rows, "chunk_rows": cands, "repeats": repeats}

    if not force:
        memo = _MEMO.get(key)
        if memo is not None and memo[0] == grid:
            return memo[1]
        disk = ec_autotune._load_cache(ec_autotune.cache_path()).get(key)
        if disk is not None and disk.get("grid") == grid:
            winner = int(disk["chunk_rows"])
            _MEMO[key] = (grid, winner)
            return winner

    timings: dict[str, float] = {}
    best, best_t = cands[0], float("inf")
    counted = dict(volume._SENT)
    try:
        for cr in cands:
            dt = _time_chunk(rows, rank, mesh, all_axes, cr, wire, repeats)
            timings[f"c{cr}"] = dt
            if dt < best_t:
                best_t, best = dt, cr
    finally:
        volume._SENT.clear()
        volume._SENT.update(counted)

    _MEMO[key] = (grid, best)
    path = ec_autotune.cache_path()
    cache = ec_autotune._load_cache(path)
    cache["_format"] = ec_autotune.CACHE_FORMAT_VERSION
    cache[key] = {"chunk_rows": int(best), "grid": grid, "timings": timings}
    ec_autotune._store_cache(path, cache)
    return best
