"""One-device MTTKRP (paper Algorithms 1–2) on torch tensors.

The counterpart of the reference package's ``core/mttkrp.py`` at world size
1. Per output mode ``d`` the device runs the EC on its shard (a CUDA kernel
or the plain PyTorch oracle, see kernels/ops.py). With one device there is
one group of one member, so the intra-group merge and the factor exchange
that follow it in the reference (collectives.py:134-136, 287-292) are the
identity: the local EC's ``(rows_max, R)`` output is already the replicated
padded factor. The multi-GPU exchange is a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.partition import (CPPlan, ModePartition,
                                        block_segment_descriptors)
from repro_torch.kernels import ops as kops

__all__ = ["DeviceArrays", "shard_plan_mode", "make_mttkrp_fn",
           "distributed_mttkrp"]


@dataclasses.dataclass(frozen=True)
class DeviceArrays:
    """One mode's shard on one device."""

    indices: torch.Tensor        # (nnz_max, N) int32
    values: torch.Tensor         # (nnz_max,) f32
    local_rows: torch.Tensor     # (nnz_max,) int32
    block_to_tile: torch.Tensor  # (nblocks,) int32
    tile_visited: torch.Tensor   # (ntiles,) f32
    # Per-block row-segment descriptors for the "sorted" EC variant; small
    # (O(nblocks * tile)) and derived from local_rows at shard time.
    seg_starts: torch.Tensor     # (nblocks, tile + 2) int32
    seg_rows: torch.Tensor       # (nblocks, tile + 1) int32

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in dataclasses.astuple(self))


def _require_one_device(part: ModePartition) -> None:
    if part.num_devices != 1:
        raise NotImplementedError(
            f"mode {part.mode} is partitioned for {part.num_devices} devices;"
            f" repro_torch runs one device until the multi-GPU exchange is "
            f"ported (ROADMAP, queue 1, 'Multi-GPU exchange')")


def shard_plan_mode(part: ModePartition, device) -> DeviceArrays:
    """Move one mode's host arrays onto ``device``, computing the sorted
    variant's segment descriptors on the way (as the reference does,
    mttkrp.py:93-99)."""
    _require_one_device(part)
    ss, sr = block_segment_descriptors(part.local_rows[0], tile=part.tile,
                                       block_p=part.block_p)

    def put(x):
        return torch.from_numpy(x).to(device)

    return DeviceArrays(
        indices=put(part.indices[0]),
        values=put(part.values[0]),
        local_rows=put(part.local_rows[0]),
        block_to_tile=put(part.block_to_tile[0]),
        tile_visited=put(part.tile_visited[0]),
        seg_starts=put(ss),
        seg_rows=put(sr),
    )


def make_mttkrp_fn(part: ModePartition, *, use_kernel: bool = True,
                   variant: str | None = None, num_buffers: int = 2):
    """The one-device MTTKRP for one mode: ``fn(dev, factors) -> (padded_rows,
    R)`` f32. ``factors`` are the padded factor matrices of every mode (the
    output mode's entry is ignored). ``variant`` selects the EC kernel, see
    repro_torch.kernels.ops."""
    _require_one_device(part)

    def fn(dev: DeviceArrays, factors: Sequence[torch.Tensor]) -> torch.Tensor:
        return kops.mttkrp_local(
            dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
            list(factors), mode=part.mode, num_rows=part.rows_max,
            tile=part.tile, block_p=part.block_p, use_kernel=use_kernel,
            variant=variant, num_buffers=num_buffers,
            tile_mask=dev.tile_visited, seg_starts=dev.seg_starts,
            seg_rows=dev.seg_rows)

    return fn


def distributed_mttkrp(plan: CPPlan, mode: int, dev_arrays: DeviceArrays,
                       factors: Sequence[torch.Tensor], **kw) -> torch.Tensor:
    """Convenience one-shot wrapper."""
    return make_mttkrp_fn(plan.modes[mode], **kw)(dev_arrays, factors)
