"""Plan layer: preprocess once on the host.

The counterpart of ``plan()`` in the reference package's
``api/planning.py``, without the plan cache, the out-of-core store and the
static analysis (each waits for the slice of the port that brings it).
"""
from __future__ import annotations

from repro_torch.api.config import DecomposeConfig
from repro_torch.core import partition as partition_mod
from repro_torch.core.coo import SparseTensor
from repro_torch.core.partition import CPPlan

__all__ = ["plan", "resolve_num_devices"]


def resolve_num_devices(config: DecomposeConfig,
                        num_devices: int | None = None) -> int:
    """Explicit argument > ``runtime.num_devices`` > 1. Never reads a device
    list; more than one device raises until the exchange is ported."""
    nd = num_devices or config.runtime.num_devices or 1
    if nd != 1:
        raise NotImplementedError(
            f"num_devices={nd}: repro_torch runs one device until the "
            f"multi-GPU exchange is ported (ROADMAP, queue 1, 'Multi-GPU "
            f"exchange')")
    return nd


def plan(tensor: SparseTensor, config: DecomposeConfig, *,
         num_devices: int | None = None) -> CPPlan:
    """Preprocess ``tensor`` for ``config``: partition every mode with the
    configured policy, replication, geometry and layout. Pure host work;
    returns a :class:`CPPlan`."""
    nd = resolve_num_devices(config, num_devices)
    if config.kernel.autotune:
        raise NotImplementedError(
            "kernel.autotune=True: the EC autotuner is not ported to "
            "repro_torch yet (ROADMAP, queue 1, 'Autotuner'); pass "
            "kernel.autotune=false (and partition.tile / partition.block_p "
            "to pick a geometry)")
    return partition_mod.build_plan(
        tensor, nd, strategy=config.resolved_policy(),
        replication=config.partition.replication,
        tile=config.partition.tile, block_p=config.partition.block_p,
        layout=config.partition.layout)
