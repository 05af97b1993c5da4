"""Autotuner for the MTTKRP EC kernel: sweep (tile, block_p, num_buffers).

The counterpart of the reference package's ``kernels/autotune.py``. The
EC's speed depends on three launch parameters fixed at partition time
(tile, block_p — they shape the blocking done by core/partition.py) or at
launch (num_buffers — the ``cp.async`` ring depth of the ``fused`` and
``sorted`` item kernels). The tuner times each candidate on a small
*representative shard* (a synthetic zipf tensor run through the port's
partitioner, in the variant's block layout) and caches the winner per
``(nmodes, rank, dtype, backend, device kind, variant)``.

Timing. On a CUDA device each candidate is ``ops.mttkrp_local`` on the
shard, timed with CUDA events: one warm-up launch, then the best of
``repeats``. On the CPU the candidates run the kernels' plain versions,
timed with ``time.perf_counter``. A candidate that fails to build or
launch raises: the tuner never returns a default in its place.

Cache format v3, the reference's (JSON)::

    {"_format": 3,
     "<nmodes>m_r<rank>_<dtype>_<backend>_<kind>_<variant>":
        {"tile": 8, "block_p": 128, "num_buffers": 2,
         "grid": {"nnz": 4096, "tiles": [8, 16], ...},
         "timings": {"t8_p128_b2": 0.0012, ...}}}

``backend`` is ``gpu`` or ``cpu``, and ``kind`` the device's name
sanitised as the reference sanitises a JAX device kind
(``torch.cuda.get_device_name()`` of an H100 gives
``nvidia-h100-80gb-hbm3``; the CPU's kind is ``cpu``). Loading an older
cache migrates it as the reference does (v1 keys gain a ``float32``
segment, v2 keys a kind equal to their backend, ``xchg_...`` entries pass
through, unrecognised keys are dropped). An entry is reused only when its
``grid`` matches the requested sweep.

The port keeps its own cache file, ``~/.cache/amped/autotune_torch.json``,
overridden by ``AMPED_TORCH_AUTOTUNE_CACHE`` (empty string: no file; an
in-process memo always applies). The reference rewrites the file it reads
and drops keys it cannot parse, so the two packages never share one.
:mod:`repro_torch.comm.autotune` keeps its ``xchg_...`` winners in the
same file. :data:`COUNTERS` counts memo hits, cache hits and misses, as
do the ``autotune.ec.*`` counters of :func:`repro_torch.obs.get_registry`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops as kops

__all__ = ["ECConfig", "autotune_ec", "cache_path", "representative_shard",
           "device_kind_tag", "backend_tag", "COUNTERS", "reset_counters",
           "CACHE_FORMAT_VERSION", "DEFAULT_TILES", "DEFAULT_BLOCK_PS",
           "DEFAULT_NUM_BUFFERS", "ENV_CACHE"]

ENV_CACHE = "AMPED_TORCH_AUTOTUNE_CACHE"
CACHE_FORMAT_VERSION = 3  # v3: device kind in the entry key

DEFAULT_TILES = (8, 16)
DEFAULT_BLOCK_PS = (64, 128)
DEFAULT_NUM_BUFFERS = (2, 3)

# v1 entry key: "<nmodes>m_r<rank>_<backend>_<variant>" (no dtype slot);
# v2 adds a dtype segment between rank and backend (5 segments total);
# v3 adds a device-kind segment between backend and variant (6 segments).
_V1_KEY_RE = re.compile(r"^(\d+m_r\d+)_([a-z]+)_(ref|blocked|fused)$")
_V2_KEY_RE = re.compile(
    r"^(\d+m_r\d+_[a-z]+\d+)_([a-z]+)_(ref|blocked|fused|sorted)$")
_V3_KEY_RE = re.compile(
    r"^\d+m_r\d+_[a-z]+\d+_[a-z]+_[a-z0-9.-]+_(ref|blocked|fused|sorted)$")

_MEMO: dict[str, tuple[dict, "ECConfig"]] = {}  # key -> (grid, winner)

# how autotune_ec answered, since the process started or the last reset
COUNTERS = {"memo_hits": 0, "cache_hits": 0, "misses": 0}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


@dataclasses.dataclass(frozen=True)
class ECConfig:
    tile: int
    block_p: int
    num_buffers: int
    timings: dict = dataclasses.field(default_factory=dict, compare=False)


def cache_path() -> str | None:
    p = os.environ.get(ENV_CACHE)
    if p == "":
        return None
    return p or os.path.expanduser("~/.cache/amped/autotune_torch.json")


def _dtype_tag(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")  # "float32", "bfloat16"
    return np.dtype(dtype).name


def _device(device=None) -> torch.device:
    """``None`` is the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the EC autotuner times candidates on the card, "
                           "and no CUDA device is available; pass "
                           "device='cpu' to tune the plain versions")
    return dev


def backend_tag(device=None) -> str:
    """The cache key's platform slot: ``gpu`` for a CUDA device, else
    ``cpu``."""
    return "gpu" if torch.device(
        "cuda" if device is None else device).type == "cuda" else "cpu"


def _sanitize_kind(kind: str) -> str:
    kind = kind.strip().lower()
    kind = re.sub(r"[\s_]+", "-", kind)
    return re.sub(r"[^a-z0-9.-]", "", kind) or "unknown"


def device_kind_tag(device=None) -> str:
    """The device's name, sanitised as the reference sanitises a JAX device
    kind: the accelerator generation slot of the v3 key (``cpu``,
    ``nvidia-h100-80gb-hbm3``)."""
    dev = _device(device)
    if dev.type != "cuda":
        return "cpu"
    return _sanitize_kind(torch.cuda.get_device_name(dev))


def _cache_key(nmodes: int, rank: int, backend: str, variant: str,
               dtype=torch.float32, kind: str | None = None) -> str:
    if kind is None:
        kind = device_kind_tag("cuda" if backend == "gpu" else "cpu")
    return (f"{nmodes}m_r{rank}_{_dtype_tag(dtype)}_{backend}_{kind}_"
            f"{variant}")


def _migrate_cache(cache: dict) -> dict:
    """Re-key an older cache to v3, as the reference does: a v1 key
    (``3m_r8_cpu_fused``) gains a ``float32`` segment, any v2 key then a
    device-kind segment equal to its backend (``..._cpu_cpu_fused``). v3
    keys and ``xchg_...`` entries pass through unchanged (idempotent);
    keys matching no known format are dropped."""
    out: dict = {"_format": CACHE_FORMAT_VERSION}
    for key, entry in cache.items():
        if key.startswith("_"):
            continue
        if key.startswith("xchg_") or _V3_KEY_RE.match(key):
            out[key] = entry
            continue
        m = _V1_KEY_RE.match(key)
        if m:  # v1 → v2 form, then fall through to the v2 → v3 step
            key = f"{m.group(1)}_float32_{m.group(2)}_{m.group(3)}"
        m = _V2_KEY_RE.match(key)
        if m:
            out[f"{m.group(1)}_{m.group(2)}_{m.group(2)}_{m.group(3)}"] = \
                entry
    return out


def _load_cache(path: str | None) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                cache = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        if cache.get("_format") != CACHE_FORMAT_VERSION:
            cache = _migrate_cache(cache)
            _store_cache(path, cache)  # persist once; later loads are v3
        return cache
    return {}


def _store_cache(path: str | None, cache: dict) -> None:
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    except OSError:
        pass  # read-only filesystems: the in-process memo still applies


def representative_shard(nmodes: int, nnz: int, tile: int | None = None,
                         block_p: int | None = None, seed: int = 0,
                         layout: str = "blocked"):
    """A zipf-skewed synthetic tensor run through the port's partitioner,
    so candidates are timed on the blocking they would produce (``layout``
    ``"sorted"`` for the ``sorted`` variant). Returns (tensor,
    single-device ModePartition of mode 0) — the reference's arrays, bit
    for bit."""
    from repro_torch.core.coo import random_sparse
    from repro_torch.core.partition import partition_mode
    dim = max(16, int(round(nnz ** (1.0 / nmodes))) * 2)
    t = random_sparse((dim,) * nmodes, nnz, seed=seed, distribution="zipf")
    kw = {}
    if tile is not None:
        kw.update(tile=tile, block_p=block_p)
    part, _, _ = partition_mode(t, 0, 1, strategy="amped_cdf", replication=1,
                                layout=layout, **kw)
    return t, part


def _time_candidate(t, part, rank: int, variant: str, num_buffers: int,
                    repeats: int, device: torch.device, seed: int = 0,
                    dtype=torch.float32) -> float:
    """Seconds of the best of ``repeats`` runs of the candidate's EC, after
    one warm-up: CUDA events on the card, the host clock on the CPU."""
    rng = np.random.default_rng(seed)
    factors = [torch.from_numpy(rng.normal(size=(s, rank))).to(
        device=device, dtype=dtype) for s in t.shape]

    from repro_torch.core.mttkrp import place_shard
    dev, _ = place_shard(part, 0, device)

    def run():
        return kops.mttkrp_local(
            dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
            factors, mode=0, num_rows=part.rows_max, tile=part.tile,
            block_p=part.block_p, variant=variant, num_buffers=num_buffers,
            seg_starts=dev.seg_starts, seg_rows=dev.seg_rows,
            items=dev.items)

    best = float("inf")
    if device.type == "cuda":
        with torch.cuda.device(device):
            run()  # build, first launch
            torch.cuda.synchronize(device)
            for _ in range(repeats):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 1e3)
        return best
    run()
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_ec(
    nmodes: int,
    rank: int,
    *,
    variant: str = "fused",
    nnz: int = 4096,
    tiles=DEFAULT_TILES,
    block_ps=DEFAULT_BLOCK_PS,
    num_buffers_grid=DEFAULT_NUM_BUFFERS,
    repeats: int = 3,
    force: bool = False,
    dtype=torch.float32,
    device=None,
) -> ECConfig:
    """Sweep the candidate grid on a representative shard on ``device``
    (``None``: the card); return (and cache) the fastest ``ECConfig`` for
    ``(nmodes, rank, dtype, backend, device kind, variant)``. ``dtype`` is
    the factor dtype the candidates are timed with.

    Variants without a ring (``ref``, ``blocked``) collapse the
    ``num_buffers`` axis; ``sorted`` candidates are timed on the row-sorted
    layout they require."""
    variant = kops.resolve_variant(variant)
    dev = _device(device)
    backend = backend_tag(dev)
    if variant not in ("fused", "sorted"):
        num_buffers_grid = (2,)  # no ring: the axis is meaningless
    layout = "sorted" if variant == "sorted" else "blocked"
    key = _cache_key(nmodes, rank, backend, variant, dtype,
                     kind=device_kind_tag(dev))
    # A cached winner is only valid for the grid that produced it.
    grid = {"nnz": nnz, "tiles": list(tiles), "block_ps": list(block_ps),
            "num_buffers_grid": list(num_buffers_grid)}

    if not force:
        memo = _MEMO.get(key)
        if memo is not None and memo[0] == grid:
            COUNTERS["memo_hits"] += 1
            obs.get_registry().inc("autotune.ec.memo_hits")
            return memo[1]
        disk = _load_cache(cache_path()).get(key)
        if disk is not None and disk.get("grid") == grid:
            COUNTERS["cache_hits"] += 1
            obs.get_registry().inc("autotune.ec.cache_hits")
            cfg = ECConfig(int(disk["tile"]), int(disk["block_p"]),
                           int(disk["num_buffers"]),
                           dict(disk.get("timings", {})))
            _MEMO[key] = (grid, cfg)
            return cfg
    COUNTERS["misses"] += 1
    obs.get_registry().inc("autotune.ec.misses")

    timings: dict[str, float] = {}
    best, best_t = None, float("inf")
    for tile in tiles:
        for block_p in block_ps:
            t, part = representative_shard(nmodes, nnz, tile, block_p,
                                           layout=layout)
            for nb in num_buffers_grid:
                dt = _time_candidate(t, part, rank, variant, nb, repeats,
                                     dev, dtype=dtype)
                timings[f"t{tile}_p{block_p}_b{nb}"] = dt
                if dt < best_t:
                    best_t, best = dt, (tile, block_p, nb)

    if best is None:
        raise ValueError(f"autotune_ec: the candidate grid {grid} is empty")
    best_cfg = ECConfig(*best, dict(timings))
    _MEMO[key] = (grid, best_cfg)
    path = cache_path()
    cache = _load_cache(path)
    cache["_format"] = CACHE_FORMAT_VERSION
    cache[key] = {"tile": best_cfg.tile, "block_p": best_cfg.block_p,
                  "num_buffers": best_cfg.num_buffers, "grid": grid,
                  "timings": timings}
    _store_cache(path, cache)
    return best_cfg
