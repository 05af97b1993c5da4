"""Plan layer: preprocess once on the host, reuse everywhere.

The counterpart of ``plan()`` in the reference package's
``api/planning.py``, with its autotuned geometry, its out-of-core
:class:`~repro_torch.store.TensorStore` path and its on-disk plan cache:

    cfg  = api.preset("sorted")
    plan = api.plan(tensor, cfg, cache_dir="plans/")   # built once
    plan = api.plan(tensor, cfg, cache_dir="plans/")   # cache hit

``plan()`` keys the cache by a **content signature** of the tensor (shape,
nnz, a strided sample digest of indices/values) and of every
partition-relevant config field (strategy, replication, resolved tile /
block_p, device count). ``save_plan``/``load_plan`` write and read the
reference's format (``manifest.json`` + ``arrays.npz``, format 3), and
:func:`plan_signature` gives the reference's hex string for the same
tensor, config and device count, so a plan cache directory is shared
between the two packages: a plan saved by one loads in the other bit for
bit, lazy store plans included. The static plan analysis of the reference
(``analyze=``) is a later slice of the port.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.config import DecomposeConfig
from repro_torch.core import partition as partition_mod
from repro_torch.core.coo import SparseTensor
from repro_torch.core.partition import CPPlan, ModeLayout, ModePartition
from repro_torch.obs import trace as obs_trace
from repro_torch.store import TensorStore
from repro_torch.store import plan as store_plan_mod

__all__ = ["plan", "plan_signature", "save_plan", "load_plan",
           "PlanSignatureError", "CACHE_STATS", "reset_cache_stats",
           "resolve_num_devices", "resolve_geometry"]

# v2: ModePartition.blocks_true + rebalance_epoch; v3: lazy (out-of-core)
# plans — store-backed manifests carry a store path + digest instead of the
# O(nnz) arrays.
PLAN_FORMAT_VERSION = 3
_SAMPLE_CAP = 65536  # strided digest sample size (cheap at billion scale)

# How often plan() rebuilt vs reused, process-wide (also counted as
# ``plan.cache_hits``/``plan.cache_misses`` in obs.get_registry()); reset
# with reset_cache_stats().
CACHE_STATS = {"hits": 0, "misses": 0}


def reset_cache_stats() -> None:
    CACHE_STATS["hits"] = 0
    CACHE_STATS["misses"] = 0


class PlanSignatureError(ValueError):
    """A stored plan's signature does not match the requesting problem."""


def _tensor_digest(t) -> str:
    """Cheap content digest: shape/nnz plus a strided sample of coordinates
    and values (their raw int32 / float32 bytes, as in the reference).
    O(min(nnz, _SAMPLE_CAP)). An out-of-core
    :class:`~repro_torch.store.TensorStore` is keyed by its manifest digest
    instead — zero data reads."""
    if isinstance(t, TensorStore):
        return f"store:{t.digest}"
    h = hashlib.sha256()
    h.update(repr((tuple(int(s) for s in t.shape), int(t.nnz))).encode())
    if t.nnz:
        step = max(1, t.nnz // _SAMPLE_CAP)
        h.update(np.ascontiguousarray(t.indices[::step]).tobytes())
        h.update(np.ascontiguousarray(t.values[::step]).tobytes())
    return h.hexdigest()


def resolve_num_devices(config: DecomposeConfig,
                        num_devices: int | None = None, *,
                        device=None) -> int:
    """Explicit argument > ``runtime.num_devices`` > the number of visible
    cards, or 1 when ``device`` is the CPU or no card is visible (the
    reference's "all visible devices")."""
    if num_devices is not None:
        return num_devices
    if config.runtime.num_devices is not None:
        return config.runtime.num_devices
    if (device is not None and torch.device(device).type == "cpu") or \
            not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def resolve_geometry(tensor_nmodes: int, config: DecomposeConfig, *,
                     device=None) -> tuple[int | None, int | None]:
    """(tile, block_p) with the reference's precedence: explicit partition
    config > the autotuned winner (``kernel.autotune``; tuned on
    ``device``, ``None`` being the card) > the partitioner's defaults
    (returned as None so the partitioner applies them)."""
    tile, block_p = config.partition.tile, config.partition.block_p
    if config.kernel.autotune:
        variant = config.kernel.resolved_variant()
        if variant != "ref":  # ref ignores the blocking geometry
            from repro_torch.kernels.autotune import autotune_ec
            tuned = autotune_ec(tensor_nmodes, config.rank, variant=variant,
                                device=device)
            if tile is None:
                tile = tuned.tile
            if block_p is None:
                block_p = tuned.block_p
    return tile, block_p


def _signature(tensor, config: DecomposeConfig, nd: int, tile, block_p,
               rebalance_epoch: int = 0) -> str:
    payload = {
        "format": PLAN_FORMAT_VERSION,
        "tensor": _tensor_digest(tensor),
        "num_devices": nd,
        "strategy": config.resolved_policy(),
        "replication": config.partition.replication,
        "tile": tile,
        "block_p": block_p,
        "layout": config.partition.layout,
        "rebalance_epoch": int(rebalance_epoch),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def plan_signature(tensor: SparseTensor | TensorStore,
                   config: DecomposeConfig, *,
                   num_devices: int | None = None,
                   rebalance_epoch: int = 0, device=None) -> str:
    """Content signature keying the plan cache: tensor identity + every
    config field that changes the partition output, with the geometry
    *resolved* (the autotuner's winner on ``device`` when the config
    autotunes) and the strategy the resolved scheduling policy.
    ``rebalance_epoch`` extends the signature for plans evolved by the
    dynamic rebalancer. The same hex string as the reference's
    ``plan_signature`` for the same tensor, config and device count."""
    nd = resolve_num_devices(config, num_devices, device=device)
    tile, block_p = resolve_geometry(tensor.nmodes, config, device=device)
    return _signature(tensor, config, nd, tile, block_p, rebalance_epoch)


# -- serialization ------------------------------------------------------------

def save_plan(p: CPPlan, path: str, *, signature: str | None = None) -> str:
    """Write a plan to ``path`` (a directory): ``manifest.json`` with all
    scalar metadata (+ optional signature) and ``arrays.npz`` with every
    ModePartition array plus the global↔padded translations, bit-exact.

    Lazy (store-backed) plans persist only the layout — the manifest
    records the tensor store's path and digest instead of the O(nnz)
    arrays, and :func:`load_plan` rebinds to the store (refusing a store
    whose digest changed)."""
    os.makedirs(path, exist_ok=True)
    lazy = bool(getattr(p.modes[0], "lazy", False)) if p.modes else False
    arrays: dict[str, np.ndarray] = {}
    manifest = {
        "format_version": PLAN_FORMAT_VERSION,
        "signature": signature,
        "shape": [int(s) for s in p.shape],
        "num_devices": int(p.num_devices),
        "norm": float(p.norm),
        "rebalance_epoch": int(p.rebalance_epoch),
        "lazy": lazy,
        "modes": [],
    }
    if lazy:
        store = p.modes[0].store
        manifest["store"] = {"path": os.path.abspath(store.path),
                             "digest": store.digest}
    for d, part in enumerate(p.modes):
        # META_FIELDS are ints except block_layout (a layout-name string)
        manifest["modes"].append(
            {k: (v if isinstance(v, str) else int(v))
             for k in ModePartition.META_FIELDS
             for v in (getattr(part, k),)})
        if not lazy:
            for k in ModePartition.ARRAY_FIELDS:
                arrays[f"mode{d}_{k}"] = getattr(part, k)
        arrays[f"g2p_{d}"] = np.asarray(p.global_to_padded[d])
        arrays[f"p2g_{d}"] = np.asarray(p.padded_to_global[d])
    tmp = os.path.join(path, "arrays.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def load_plan(path: str, *, expect_signature: str | None = None) -> CPPlan:
    """Load a plan saved by :func:`save_plan` (or by the reference's). If
    ``expect_signature`` is given and the stored manifest's signature
    differs (different tensor, strategy, device count, ...), raise
    :class:`PlanSignatureError` rather than silently handing back a plan
    for another problem."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != PLAN_FORMAT_VERSION:
        raise PlanSignatureError(
            f"plan at {path!r} has format {manifest.get('format_version')}, "
            f"expected {PLAN_FORMAT_VERSION}")
    if expect_signature is not None and \
            manifest.get("signature") != expect_signature:
        raise PlanSignatureError(
            f"plan at {path!r} was built for a different problem "
            f"(stored signature {str(manifest.get('signature'))[:16]}…, "
            f"expected {expect_signature[:16]}…)")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        modes, g2ps, p2gs = [], [], []
        for d, meta in enumerate(manifest["modes"]):
            if not manifest.get("lazy"):
                # block_layout: string, absent in manifests written before
                # the sorted layout existed (same format version)
                fields = {k: int(meta[k])
                          for k in ModePartition.META_FIELDS
                          if k != "block_layout"}
                fields["block_layout"] = str(
                    meta.get("block_layout", "blocked"))
                fields.update({k: npz[f"mode{d}_{k}"]
                               for k in ModePartition.ARRAY_FIELDS})
                modes.append(ModePartition(**fields))
            g2ps.append(npz[f"g2p_{d}"])
            p2gs.append(npz[f"p2g_{d}"])
    if manifest.get("lazy"):
        modes = _rebind_lazy_modes(path, manifest, g2ps, p2gs)
    return CPPlan(
        shape=tuple(manifest["shape"]),
        num_devices=int(manifest["num_devices"]),
        modes=tuple(modes),
        global_to_padded=tuple(g2ps),
        padded_to_global=tuple(p2gs),
        norm=float(manifest["norm"]),
        rebalance_epoch=int(manifest.get("rebalance_epoch", 0)),
    )


def _rebind_lazy_modes(path: str, manifest: dict, g2ps, p2gs):
    """Reattach a persisted lazy plan to its tensor store: reopen the store
    named in the manifest, verify its digest is still the one the plan was
    built from, and rebuild the lazy partitions from the saved layouts
    (owner groups are recoverable from ``g2p // rows_max``; everything else
    re-derives from the store's histogram sidecars — no chunk is read)."""
    ref = manifest.get("store") or {}
    try:
        store = TensorStore(ref.get("path", ""))
    except (OSError, ValueError) as e:
        raise PlanSignatureError(
            f"lazy plan at {path!r} references tensor store "
            f"{ref.get('path')!r}, which no longer opens: {e}") from e
    if store.digest != ref.get("digest"):
        raise PlanSignatureError(
            f"lazy plan at {path!r} was built from store digest "
            f"{str(ref.get('digest'))[:16]}…, but {store.path!r} now has "
            f"{store.digest[:16]}… (store rewritten since planning)")
    layouts = []
    for d, meta in enumerate(manifest["modes"]):
        g2p = np.asarray(g2ps[d], np.int64)
        rows_max = int(meta["rows_max"])
        owner = (g2p // rows_max).astype(np.int32)
        layouts.append(ModeLayout(
            mode=int(meta["mode"]), num_devices=int(meta["num_devices"]),
            r=int(meta["r"]), n_groups=int(meta["n_groups"]),
            rows_max=rows_max, tile=int(meta["tile"]),
            block_p=int(meta["block_p"]), owner=owner,
            global_to_padded=g2p,
            padded_to_global=np.asarray(p2gs[d], np.int64),
            rows_owned=np.bincount(owner, minlength=int(meta["n_groups"])
                                   ).astype(np.int64),
            block_layout=str(meta.get("block_layout", "blocked"))))
    return store_plan_mod.lazy_parts_from_layouts(store, layouts)


# -- the public entry ---------------------------------------------------------

def plan(tensor: SparseTensor | TensorStore, config: DecomposeConfig, *,
         cache_dir: str | None = None, num_devices: int | None = None,
         device=None) -> CPPlan:
    """Preprocess ``tensor`` for ``config``: autotune the blocking geometry
    (if asked), partition every mode with the configured policy,
    replication, geometry and layout for :func:`resolve_num_devices`
    devices (``device`` is where the plan will run: the autotuner times
    its candidates there, and it sets the device-count default), and —
    when ``cache_dir`` is given — reuse an on-disk plan whose content
    signature matches instead of repartitioning (a corrupt or stale entry
    is rebuilt and overwritten). Pure host work apart from the tuner;
    returns a :class:`CPPlan`.

    ``tensor`` may be an out-of-core :class:`~repro_torch.store.TensorStore`:
    the partition is then computed from the store's manifest histograms
    alone — no chunk is read here — and the plan's modes materialize
    per-device shards from the store at compile time
    (:class:`~repro_torch.store.StoreModePartition`)."""
    with obs_trace.span("plan", annotate=True):
        nd = resolve_num_devices(config, num_devices, device=device)
        tile, block_p = resolve_geometry(tensor.nmodes, config,
                                         device=device)

        sig = None
        if cache_dir is not None:
            sig = _signature(tensor, config, nd, tile, block_p)
            entry = os.path.join(cache_dir, sig[:32])
            if os.path.exists(os.path.join(entry, "manifest.json")):
                try:
                    p = partition_mod.validate_plan(
                        load_plan(entry, expect_signature=sig))
                    CACHE_STATS["hits"] += 1
                    obs.get_registry().inc("plan.cache_hits")
                    return p
                except (PlanSignatureError, OSError, KeyError, ValueError):
                    pass  # corrupted/stale entry: rebuild below, overwrite

        CACHE_STATS["misses"] += 1
        obs.get_registry().inc("plan.cache_misses")
        build = store_plan_mod.build_plan_from_store \
            if isinstance(tensor, TensorStore) else partition_mod.build_plan
        p = build(tensor, nd, strategy=config.resolved_policy(),
                  replication=config.partition.replication, tile=tile,
                  block_p=block_p, layout=config.partition.layout)
        if cache_dir is not None:
            try:
                save_plan(p, os.path.join(cache_dir, sig[:32]), signature=sig)
            except OSError:
                pass  # read-only filesystems: the plan still works in-process
        return p
