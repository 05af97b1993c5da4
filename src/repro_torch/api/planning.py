"""Plan layer: preprocess once on the host.

The counterpart of ``plan()`` in the reference package's
``api/planning.py``, without the plan cache, the out-of-core store and the
static analysis (each waits for the slice of the port that brings it).
"""
from __future__ import annotations

import torch

from repro_torch.api.config import DecomposeConfig
from repro_torch.comm import resolve_exchange_spec
from repro_torch.core import partition as partition_mod
from repro_torch.core.coo import SparseTensor
from repro_torch.core.partition import CPPlan

__all__ = ["plan", "resolve_num_devices"]


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


def plan(tensor: SparseTensor, config: DecomposeConfig, *,
         num_devices: int | None = None, device=None) -> CPPlan:
    """Preprocess ``tensor`` for ``config``: partition every mode with the
    configured policy, replication, geometry and layout for
    :func:`resolve_num_devices` devices (``device`` is where the plan will
    run, for that default). Pure host work; returns a :class:`CPPlan`."""
    nd = resolve_num_devices(config, num_devices, device=device)
    if config.kernel.autotune:
        raise NotImplementedError(
            "kernel.autotune=True: the EC autotuner is not ported to "
            "repro_torch yet (ROADMAP, queue 1, 'Autotuner'); pass "
            "kernel.autotune=false (and partition.tile / partition.block_p "
            "to pick a geometry)")
    resolve_exchange_spec(config.exchange)  # raises for the chunk autotuner
    return partition_mod.build_plan(
        tensor, nd, strategy=config.resolved_policy(),
        replication=config.partition.replication,
        tile=config.partition.tile, block_p=config.partition.block_p,
        layout=config.partition.layout)
