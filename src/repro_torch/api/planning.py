"""Plan layer: preprocess once on the host.

The counterpart of ``plan()`` in the reference package's
``api/planning.py``, with its autotuned geometry and its out-of-core
:class:`~repro_torch.store.TensorStore` path; without the plan cache and
the static analysis (each waits for the slice of the port that brings it).
"""
from __future__ import annotations

import torch

from repro_torch.api.config import DecomposeConfig
from repro_torch.core import partition as partition_mod
from repro_torch.core.coo import SparseTensor
from repro_torch.core.partition import CPPlan
from repro_torch.store import TensorStore
from repro_torch.store import plan as store_plan_mod

__all__ = ["plan", "resolve_num_devices", "resolve_geometry"]


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


def plan(tensor: SparseTensor | TensorStore, config: DecomposeConfig, *,
         num_devices: int | None = None, device=None) -> CPPlan:
    """Preprocess ``tensor`` for ``config``: autotune the blocking geometry
    (if asked), partition every mode with the configured policy,
    replication, geometry and layout for :func:`resolve_num_devices`
    devices (``device`` is where the plan will run: the autotuner times
    its candidates there, and it sets the device-count default). Pure host
    work apart from the tuner; returns a :class:`CPPlan`.

    ``tensor`` may be an out-of-core :class:`~repro_torch.store.TensorStore`:
    the partition is then computed from the store's manifest histograms
    alone — no chunk is read here — and the plan's modes materialize
    per-device shards from the store at compile time
    (:class:`~repro_torch.store.StoreModePartition`)."""
    nd = resolve_num_devices(config, num_devices, device=device)
    tile, block_p = resolve_geometry(tensor.nmodes, config, device=device)
    build = store_plan_mod.build_plan_from_store \
        if isinstance(tensor, TensorStore) else partition_mod.build_plan
    return build(
        tensor, nd, strategy=config.resolved_policy(),
        replication=config.partition.replication, tile=tile,
        block_p=block_p, layout=config.partition.layout)
