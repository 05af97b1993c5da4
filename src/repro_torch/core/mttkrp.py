"""Distributed MTTKRP (paper Algorithms 1–2) on per-device torch tensors.

The counterpart of the reference package's ``core/mttkrp.py``. There one
``shard_map`` program runs on every device of a ``(group, sub)`` mesh; here
one controller drives the logical devices of a :class:`CPMesh`, holding
every per-device value as a list in linear device order ``g * r + s``.
Per output mode ``d``:

  1. every device runs the EC on its shard (a CUDA kernel or the plain
     PyTorch oracle, see kernels/ops.py) — no cross-device write conflicts
     by the partitioning invariant,
  2. replication groups (r>1) merge partials with an intra-group
     reduce-scatter (``psum_scatter`` or the explicit ``ring_rs``
     schedule; identity for the paper's r=1),
  3. the output factor partitions are exchanged via the configured
     :class:`repro_torch.comm.ExchangeSpec` — the plain all-gather, the
     Algorithm-3 ``ring``, or the chunked ``overlap`` schedule, optionally
     on a bf16 wire — giving every device the replicated padded factor
     for the next mode.

A "replicated" tensor is a list of per-device tensors that hold the same
bits. Logical devices may share a card (or the CPU) when the caller asks
for it with ``cp_mesh(M, r, devices=[...])``; on one device merge and
exchange are the identity.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import torch

from repro_torch import comm
from repro_torch.core.partition import (CPPlan, ModePartition,
                                        block_segment_descriptors)
from repro_torch.kernels import ops as kops

__all__ = ["CPMesh", "cp_mesh", "DeviceArrays", "shard_plan_mode",
           "MTTKRPFn", "make_mttkrp_fn", "distributed_mttkrp"]

AXES = ("group", "sub")


@dataclasses.dataclass(frozen=True)
class CPMesh:
    """The logical devices of a CP run, laid out ``(n_groups, r)`` as
    ``("group", "sub")``. ``devices[g * r + s]`` is the ``torch.device`` of
    logical device ``(g, s)``; the partitioner's shard ``k`` runs on
    ``devices[k]``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]          # (n_groups, r)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def n_groups(self) -> int:
        return self.shape[0]

    @property
    def r(self) -> int:
        return self.shape[1]

    def axis_groups(self, axis_names) -> list[list[int]]:
        """The sets of logical devices that communicate along
        ``axis_names`` (one name or a tuple): one list per combination of
        the other axes' coordinates, ordered by the linear index over
        ``axis_names`` (for ``("group", "sub")`` that is ``g * r + s``)."""
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        if not names or any(n not in AXES for n in names):
            raise ValueError(f"mesh axes are {AXES}, got {axis_names!r}")
        sizes = dict(zip(AXES, self.shape))
        rest = [a for a in AXES if a not in names]
        groups = []
        for rc in itertools.product(*(range(sizes[a]) for a in rest)):
            ids = []
            for nc in itertools.product(*(range(sizes[a]) for a in names)):
                c = dict(zip(rest, rc))
                c.update(zip(names, nc))
                ids.append(c["group"] * self.r + c["sub"])
            groups.append(ids)
        return groups


def cp_mesh(num_devices: int, r: int, devices=None) -> CPMesh:
    """Mesh for CP runs: (group, sub) with |sub| = r.

    ``devices`` defaults to ``cuda:0 .. cuda:M-1`` and raises when fewer
    cards are visible. Several logical devices share a card (or the CPU)
    only when the caller says so, e.g. ``cp_mesh(4, r, devices=["cuda:0"] *
    4)`` or ``devices=["cpu"] * 4``."""
    if num_devices < 1 or r < 1 or num_devices % r:
        raise ValueError(f"replication r={r} must divide num_devices="
                         f"{num_devices}")
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if visible < num_devices:
            raise RuntimeError(
                f"cp_mesh({num_devices}, {r}) puts logical device k on "
                f"cuda:k, but {visible} CUDA device(s) are visible. To place "
                f"several logical devices on one card, ask for it: "
                f"cp_mesh({num_devices}, {r}, devices=['cuda:0'] * "
                f"{num_devices}) (or devices=['cpu'] * {num_devices} on the "
                f"CPU)")
        devices = [f"cuda:{k}" for k in range(num_devices)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != num_devices:
        raise ValueError(f"cp_mesh({num_devices}, {r}) got {len(devs)} "
                         f"devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh lies on one kind of device, got "
                         f"{[str(d) for d in devs]}")
    if devs[0].type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * M for a mesh on the CPU")
        devs = [d if d.index is not None
                else torch.device("cuda", torch.cuda.current_device())
                for d in devs]
        bad = [str(d) for d in devs if d.index >= torch.cuda.device_count()]
        if bad:
            raise RuntimeError(f"{bad} are not visible; "
                               f"{torch.cuda.device_count()} CUDA device(s) "
                               f"are")
    return CPMesh(tuple(devs), (num_devices // r, r))


def _check_mesh(part: ModePartition, mesh: CPMesh) -> None:
    if (part.n_groups, part.r) != mesh.shape:
        raise ValueError(
            f"mode {part.mode} is partitioned for a {part.n_groups}x{part.r} "
            f"(group, sub) grid, but the mesh is {mesh.shape[0]}x"
            f"{mesh.shape[1]}")


@dataclasses.dataclass(frozen=True)
class DeviceArrays:
    """One mode's shard on one logical device."""

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


def shard_plan_mode(part: ModePartition, mesh: CPMesh) -> list[DeviceArrays]:
    """Move one mode's host arrays onto the mesh, shard ``k`` onto logical
    device ``k``, computing the sorted variant's segment descriptors on the
    way (as the reference does, mttkrp.py:93-99)."""
    _check_mesh(part, mesh)
    out = []
    for k, device in enumerate(mesh.devices):
        ss, sr = block_segment_descriptors(part.local_rows[k],
                                           tile=part.tile,
                                           block_p=part.block_p)

        def put(x):
            return torch.from_numpy(x).to(device, copy=True)

        out.append(DeviceArrays(
            indices=put(part.indices[k]),
            values=put(part.values[k]),
            local_rows=put(part.local_rows[k]),
            block_to_tile=put(part.block_to_tile[k]),
            tile_visited=put(part.tile_visited[k]),
            seg_starts=put(ss),
            seg_rows=put(sr),
        ))
    return out


class MTTKRPFn:
    """The distributed MTTKRP for one mode (see :func:`make_mttkrp_fn`):
    ``fn(dev_arrays, factors)`` is ``fn.exchange(fn.local(dev_arrays,
    factors))``, the two stages exposed so a caller can time them apart."""

    def __init__(self, part: ModePartition, mesh: CPMesh, *,
                 kernel_kw: dict, exchange_spec: comm.ExchangeSpec):
        _check_mesh(part, mesh)
        self.part, self.mesh = part, mesh
        self.kernel_kw = kernel_kw
        self.exchange_spec = exchange_spec

    def local(self, dev_arrays: Sequence[DeviceArrays],
              factors: Sequence[Sequence[torch.Tensor]]
              ) -> list[torch.Tensor]:
        """Every device's EC on its shard: ``(rows_max, R)`` partials."""
        p = self.part
        return [kops.mttkrp_local(
            dev.indices, dev.values, dev.local_rows, dev.block_to_tile,
            [f[k] for f in factors], mode=p.mode, num_rows=p.rows_max,
            tile=p.tile, block_p=p.block_p, tile_mask=dev.tile_visited,
            seg_starts=dev.seg_starts, seg_rows=dev.seg_rows,
            **self.kernel_kw) for k, dev in enumerate(dev_arrays)]

    def exchange(self, partials: Sequence[torch.Tensor]
                 ) -> list[torch.Tensor]:
        """Merge (r > 1) and gather: the replicated padded output."""
        spec = self.exchange_spec
        merged = comm.merge_partials(
            partials, self.mesh, "sub" if self.part.r > 1 else None,
            **spec.merge_kwargs())
        return comm.all_gather_axes(merged, self.mesh, AXES,
                                    **spec.gather_kwargs())

    def __call__(self, dev_arrays, factors) -> list[torch.Tensor]:
        return self.exchange(self.local(dev_arrays, factors))


def make_mttkrp_fn(part: ModePartition, mesh: CPMesh, *,
                   use_kernel: bool = True, variant: str | None = None,
                   num_buffers: int = 2,
                   exchange_spec: comm.ExchangeSpec | None = None
                   ) -> MTTKRPFn:
    """The distributed MTTKRP for one mode: ``fn(dev_arrays, factors) ->``
    per device the replicated padded output factor ``(padded_rows, R)``
    f32. ``dev_arrays`` is :func:`shard_plan_mode`'s list; ``factors[w]``
    is the replicated padded factor of mode ``w`` (a per-device list; the
    output mode's entry is ignored).

    ``variant`` selects the EC kernel (see repro_torch.kernels.ops);
    ``exchange_spec`` the exchange schedule — gather variant, merge
    variant, overlap chunk size, wire dtype; unset, it is
    ``resolve_exchange_spec(None)``: the environment, then the defaults."""
    if exchange_spec is None:
        exchange_spec = comm.resolve_exchange_spec(None)
    return MTTKRPFn(part, mesh,
                    kernel_kw=dict(use_kernel=use_kernel, variant=variant,
                                   num_buffers=num_buffers),
                    exchange_spec=exchange_spec)


def distributed_mttkrp(plan: CPPlan, mode: int, mesh: CPMesh,
                       dev_arrays: Sequence[DeviceArrays],
                       factors: Sequence[Sequence[torch.Tensor]],
                       **kw) -> list[torch.Tensor]:
    """Convenience one-shot wrapper."""
    return make_mttkrp_fn(plan.modes[mode], mesh, **kw)(dev_arrays, factors)
