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

Epoch streaming splits one mode's MTTKRP into per-super-shard partial ECs
folded into a zero accumulator (:func:`make_partial_mttkrp_fn`) and one
merge + exchange on the sum (:func:`make_streaming_finish_fn`). The
super-shards of an out-of-core plan are placed by
:func:`shard_super_shard`, each device's window into its own tensors.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from repro_torch import comm
from repro_torch.core.partition import (CPPlan, ModePartition,
                                        block_segment_descriptors)
from repro_torch.kernels import ops as kops

__all__ = ["CPMesh", "cp_mesh", "DeviceArrays", "Placed", "place_mode",
           "shard_plan_mode", "MTTKRPFn", "make_mttkrp_fn",
           "distributed_mttkrp", "shard_super_shard", "zero_partials",
           "make_partial_mttkrp_fn", "make_streaming_finish_fn"]

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


_ARRAY_NAMES = ("indices", "values", "local_rows", "block_to_tile",
                "tile_visited", "seg_starts", "seg_rows")


@dataclasses.dataclass(frozen=True)
class Placed:
    """One key's shards on the mesh, as a placement thread left them:
    ``arrays[k]`` lies on logical device ``k``, and where it was copied on
    a side CUDA stream, ``ready[k]`` is the event recorded after its last
    copy (``None``: already usable on every stream)."""

    arrays: list[DeviceArrays]
    ready: list

    def wait(self) -> list[DeviceArrays]:
        """Make each device's current stream wait for its copies, and mark
        the tensors used on that stream (``record_stream``), so that the
        caching allocator does not hand their memory out again while a
        kernel of that stream may still read it. Returns ``arrays``."""
        for dev, ev in zip(self.arrays, self.ready):
            if ev is None:
                continue
            stream = torch.cuda.current_stream(dev.values.device)
            stream.wait_event(ev)
            for t in dataclasses.astuple(dev):
                t.record_stream(stream)
        return self.arrays


def _place_device(host: Sequence[np.ndarray], device: torch.device,
                  stream=None) -> tuple[DeviceArrays, object]:
    """One device's seven host arrays onto ``device``. With a side CUDA
    ``stream``, each array is copied into a pinned host buffer and from
    there to the card on that stream, and an event is recorded after the
    last copy: the host does not wait for the transfer. Pinning that fails
    raises; there is no pageable fallback. Without one, the copies are
    ordinary synchronous ones."""
    if stream is None or device.type != "cuda":
        return DeviceArrays(*(torch.from_numpy(np.ascontiguousarray(x)).to(
            device, copy=True) for x in host)), None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = []
        for x in host:
            pinned = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            # the caching host allocator keeps the pinned block until this
            # copy has run
            out.append(pinned.to(device, non_blocking=True))
        ev = torch.cuda.Event()
        ev.record(stream)
    return DeviceArrays(*out), ev


def _device_host_arrays(part, k: int) -> tuple[np.ndarray, ...]:
    """Device ``k``'s seven host arrays of ``part``: a lazy partition's
    payload is materialized from its store here, one device at a time."""
    if getattr(part, "lazy", False):
        ind, val, rows = part.device_arrays(k)
    else:
        ind, val, rows = (part.indices[k], part.values[k],
                          part.local_rows[k])
    ss, sr = block_segment_descriptors(rows, tile=part.tile,
                                       block_p=part.block_p)
    return (ind, val, rows, part.block_to_tile[k], part.tile_visited[k],
            ss, sr)


def place_mode(part, mesh: CPMesh, streams=None) -> Placed:
    """Move one mode's host arrays onto the mesh, shard ``k`` onto logical
    device ``k``, computing the sorted variant's segment descriptors on the
    way (as the reference does, mttkrp.py:93-99). Out-of-core partitions
    (``part.lazy``) never stack a host ``(m, nnz_max)`` array: each
    device's slice is streamed from the store and placed before the next
    one is read. ``streams`` maps a card index to its side copy stream
    (see :func:`_place_device`); ``None`` copies synchronously."""
    _check_mesh(part, mesh)
    arrays, ready = [], []
    for k, device in enumerate(mesh.devices):
        host = _device_host_arrays(part, k)
        stream = None if streams is None or device.type != "cuda" \
            else streams[device.index]
        dev, ev = _place_device(host, device, stream)
        del host  # host copy freed before the next device's slice
        arrays.append(dev)
        ready.append(ev)
    return Placed(arrays, ready)


def shard_plan_mode(part, mesh: CPMesh) -> list[DeviceArrays]:
    """:func:`place_mode` with synchronous copies: the shards, usable on
    every stream when this returns."""
    return place_mode(part, mesh).arrays


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


# -- epoch streaming: super-shard partial accumulation ------------------------

def shard_super_shard(part, stream_plan, k: int, mesh: CPMesh, *,
                      spill=None, streams=None) -> Placed:
    """Place super-shard ``k`` of an out-of-core mode on the mesh: each
    logical device gets its own tensors for its tile window
    ``stream_plan.windows[dev][k]`` (the blocking metadata differs per
    window, not only the payload). Shapes are the stream plan's caps, so
    every super-shard of a mode has one shape. Devices whose window list is
    exhausted get empty ``(0, 0)`` windows: pure padding, exact no-ops
    under the tile mask.

    ``spill`` (a :class:`~repro_torch.sparse.stream.WindowSpill`)
    short-circuits the chunk-scan materialization with the window's on-disk
    copy from an earlier sweep; non-empty windows built fresh are saved
    back. The ``sorted`` descriptors are computed from the window's
    ``local_rows`` after any spill load, as the reference does, so the
    spill holds five arrays. ``streams`` as in :func:`place_mode`."""
    _check_mesh(part, mesh)
    sp = stream_plan
    arrays, ready = [], []
    for dev_id, device in enumerate(mesh.devices):
        t0, t1 = sp.windows[dev_id][k]
        skey = (k, t0, t1, sp.nnz_cap, sp.nblocks)
        arrs = (spill.load(part.mode, dev_id, skey)
                if spill is not None else None)
        if arrs is None:
            arrs = part.super_shard_arrays(dev_id, t0, t1,
                                           nnz_cap=sp.nnz_cap,
                                           nblocks=sp.nblocks)
            if spill is not None and t1 > t0:
                spill.save(part.mode, dev_id, skey, arrs)
        host = tuple(arrs) + block_segment_descriptors(
            arrs[2], tile=part.tile, block_p=part.block_p)
        stream = None if streams is None or device.type != "cuda" \
            else streams[device.index]
        dev, ev = _place_device(host, device, stream)
        del arrs, host  # host copy freed before the next device's window
        arrays.append(dev)
        ready.append(ev)
    return Placed(arrays, ready)


def zero_partials(part, mesh: CPMesh, rank: int) -> list[torch.Tensor]:
    """Zero per-device MTTKRP accumulators, ``(rows_max, R)`` f32 on each
    logical device — the running sums super-shard partials fold into."""
    return [torch.zeros((part.rows_max, rank), dtype=torch.float32,
                        device=d) for d in mesh.devices]


def make_partial_mttkrp_fn(part, mesh: CPMesh, *, use_kernel: bool = True,
                           variant: str | None = None, num_buffers: int = 2):
    """``fn(acc, dev_arrays, factors) -> acc``: every device's local EC on
    its super-shard, added into its accumulator in place — no merge, no
    gather.

    Super-shards split at tile boundaries, so each output row is produced
    by ONE super-shard's EC, with the resident shard's block order and
    slot order; every other super-shard adds an exact 0.0 there (masked
    tiles). A zero accumulator therefore ends up holding the resident
    partial bit for bit — also where a window's trailing pad blocks
    lengthen its last tile's run past ``CHUNK_BLOCKS``: those blocks add
    exact zeros to the chunk partials — and the finish
    (:func:`make_streaming_finish_fn`) is the resident exchange."""
    local = MTTKRPFn(part, mesh,
                     kernel_kw=dict(use_kernel=use_kernel, variant=variant,
                                    num_buffers=num_buffers),
                     exchange_spec=comm.ExchangeSpec()).local

    def fn(acc, dev_arrays, factors):
        for a, partial in zip(acc, local(dev_arrays, factors), strict=True):
            a.add_(partial)
        return acc

    return fn


def make_streaming_finish_fn(part, mesh: CPMesh, *,
                             exchange_spec: comm.ExchangeSpec | None = None):
    """``fn(acc) ->`` per device the replicated padded output
    ``(padded_rows, R)``: the merge (r > 1) and gather of
    :func:`make_mttkrp_fn`, run once on the accumulated partials — the
    same collectives, schedule and wire dtype as the resident path."""
    if exchange_spec is None:
        exchange_spec = comm.resolve_exchange_spec(None)
    return MTTKRPFn(part, mesh, kernel_kw={},
                    exchange_spec=exchange_spec).exchange


def distributed_mttkrp(plan: CPPlan, mode: int, mesh: CPMesh,
                       dev_arrays: Sequence[DeviceArrays],
                       factors: Sequence[Sequence[torch.Tensor]],
                       **kw) -> list[torch.Tensor]:
    """Convenience one-shot wrapper."""
    return make_mttkrp_fn(plan.modes[mode], mesh, **kw)(dev_arrays, factors)
