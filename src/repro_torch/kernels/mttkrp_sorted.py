"""``ec_sorted``: segmented-reduction EC on the row-sorted block layout.

Replaces the TPU kernel ``ec_sorted`` (src/repro/kernels/mttkrp_sorted.py:133,
body ``_sorted_kernel`` :50-130) with a CUDA kernel written for Hopper,
``csrc/ec_sorted.cu``.

What it computes. Per kernel block of ``block_p`` slots: gather ``nin``
factor rows per nonzero, form ``e = val ⊙ Π rows`` in f32, and add the
products of each of the block's at most ``tile + 1`` row segments
(``seg_starts``/``seg_rows`` from ``core.partition.block_segment_descriptors``)
into its output row. Order of the sums: a tile's run of at most
``_build.CHUNK_BLOCKS`` blocks sums each row in slot order (the bits of the
slot-order ``ref``); a longer run sums each chunk of that many blocks in
slot order and the chunks in chunk order (``ref.ec_rows_chunked``). The
result is bitwise that of :func:`ec_sorted_plain` on the CPU and on the
card (whose ``index_add_`` runs in slot order, ``ref.slot_order_index_add``)
wherever the factors are finite. The kernel ends each work item's walk after
its last slot whose value is not 0 (``_build.walked_slots`` counts the
slots it walks), so it skips the pad slots at a run's end, which add
``0·rows = ±0``; the plain version sums them. So an inf or a NaN in a pad
slot's input row (row 0 of each input factor) reaches the pads' output row
through ``0·inf`` in the plain version only.

What bounds it on the H100. Bytes, in principle: per slot it reads a
value, ``nin`` indices and ``nin`` factor rows of ``R`` f32, and does
``(nin + 1)·R`` flops on them — far below the card's ~20 flops per byte.
The least time is every input read once (values, indices, descriptors, the
distinct factor rows) and the output written once, over 3.35 TB/s; the
factor rows are read once per slot, from L1 or L2 where they stay there.
Its first Hopper design (one lane a column, rows staged through a shared
``cp.async`` ring) spent ~100 warp instructions a slot and was bound by
instruction issue instead (PERF.md §6).

What the design does about it. The TPU ran the grid in order on one core
and kept the output tile in VMEM across the blocks of a tile. Here runs are
cut into work items of at most ``CHUNK_BLOCKS`` blocks (``_build.tile_chunks``),
one warp each, so a hot tile's run is spread over the SMs; a split run's
items write ``(tile, R)`` partials that ``ec_combine`` adds in item order.
A warp walks its item's slots in steps of ``_build.step_width(R)`` slots:
it is cut into lane groups that each take one slot's whole factor rows as
16-byte read-only loads, which L1 caches (4 slots a step at R 32, one at
R 128; one column a lane where ``R % 4 != 0``), ``num_buffers - 1`` steps
ahead in registers, the slots' values and indices read 32 at a time a
chunk ahead and handed to the groups by shuffles. The step's products
pass through a staging row of shared memory to lanes that each hold
columns of the running sum, which add them in slot order; the block's
segment descriptors, copied a block ahead, say where the row changes, and
only there does the sum move to the warp's ``(tile, R)`` shared
accumulator. R 32 with 16-byte rows has a kernel compiled for that rank.
The warp reads its last block's values beside its first two chunks, finds
its last nonzero value with a warp reduction, and walks no slot after it
(``_build.walked_slots``; ``_build.step_slots`` counts the steps' lane
groups): under a Zipf skew most tiles hold a handful of nonzeros in a
block of ``block_p`` slots. ``num_buffers`` changes no bit.
What it gives up: strict slot order on runs longer than ``CHUNK_BLOCKS``
blocks, for the fixed two-level order.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ec_rows_chunked

__all__ = ["ec_sorted", "ec_sorted_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 14 + [_I] * 10 + [_P]


def _check_args(values, seg_starts, seg_rows, input_indices, factors, *,
                num_rows, tile, block_p, num_buffers):
    nnz = values.shape[0]
    _build.check_blocking(nnz, num_rows=num_rows, tile=tile, block_p=block_p,
                          num_buffers=num_buffers)
    nblocks, nin = nnz // block_p, len(factors)
    nseg = seg_rows.shape[-1]
    if tuple(input_indices.shape) != (nnz, nin):
        raise ValueError(f"input_indices has shape "
                         f"{tuple(input_indices.shape)}, expected {(nnz, nin)}")
    if tuple(seg_starts.shape) != (nblocks, nseg + 1) or \
            tuple(seg_rows.shape) != (nblocks, nseg):
        raise ValueError(f"segment descriptors have shapes "
                         f"{tuple(seg_starts.shape)} / {tuple(seg_rows.shape)},"
                         f" expected {(nblocks, nseg + 1)} / {(nblocks, nseg)}")


def ec_sorted(
    values: torch.Tensor,              # (nnz,)  nnz = nblocks * block_p
    seg_starts: torch.Tensor,          # (nblocks, S+1) int32, S = tile+1
    seg_rows: torch.Tensor,            # (nblocks, S) int32 in [0, tile)
    block_to_tile: torch.Tensor,       # (nblocks,) int32
    input_indices: torch.Tensor,       # (nnz, nin) int32 rows into factors[w]
    factors: Sequence[torch.Tensor],   # nin tensors (padded_w, R)
    *,
    num_rows: int,                     # rows_max (multiple of tile)
    tile: int,
    block_p: int,
    num_buffers: int = 2,
    items: torch.Tensor,               # _build.pack_items(block_to_tile)
) -> torch.Tensor:
    """Segmented-reduction EC. Returns (num_rows, R) f32.

    CPU tensors take :func:`ec_sorted_plain`; CUDA tensors launch the
    kernel, or raise. ``input_indices[:, j]`` indexes ``factors[j]`` (the
    output mode is compacted away by the caller, see ops.py). ``items``
    are the placed shard's work items (``DeviceArrays.items``), checked
    and counted on every call (``_build.count_items``); the plain version
    needs none."""
    _check_args(values, seg_starts, seg_rows, input_indices, factors,
                num_rows=num_rows, tile=tile, block_p=block_p,
                num_buffers=num_buffers)
    _build.count_items(items, values.shape[0] // block_p,
                       values.device)
    if values.device.type == "cpu":
        return ec_sorted_plain(values, seg_starts, seg_rows, block_to_tile,
                               input_indices, factors, num_rows=num_rows,
                               tile=tile, block_p=block_p)
    if values.device.type != "cuda":
        raise ValueError(f"ec_sorted runs on cpu or cuda tensors, got "
                         f"{values.device}")
    return _launch(values, seg_starts, seg_rows, block_to_tile, input_indices,
                   factors, num_rows=num_rows, tile=tile, block_p=block_p,
                   num_buffers=num_buffers, items=items)


def ec_sorted_plain(values, seg_starts, seg_rows, block_to_tile,
                    input_indices, factors, *, num_rows: int, tile: int,
                    block_p: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ec_sorted`, on any device: rebuild
    each slot's output row from the descriptors, then sum in the kernel's
    two-level order (``ref.ec_rows_chunked``)."""
    nblocks = block_to_tile.shape[0]
    slots = torch.arange(block_p, dtype=seg_starts.dtype,
                         device=seg_starts.device).expand(nblocks, block_p)
    # slot p lies in segment s iff seg_starts[s] <= p < seg_starts[s + 1]:
    # count the segment ends at or before p
    seg = torch.searchsorted(seg_starts[:, 1:].contiguous(),
                             slots.contiguous(), right=True)
    rows = (block_to_tile.long()[:, None] * tile
            + seg_rows.long().gather(1, seg)).reshape(-1)
    gathered = [f.index_select(0, input_indices[:, j])
                for j, f in enumerate(factors)]
    return ec_rows_chunked(values, gathered, rows, num_rows, block_to_tile,
                           tile=tile, block_p=block_p,
                           chunk_blocks=_build.CHUNK_BLOCKS)


def _launch(values, seg_starts, seg_rows, block_to_tile, input_indices,
            factors, *, num_rows, tile, block_p, num_buffers, items):
    dev = values.device
    nnz, nin = input_indices.shape
    nblocks, nseg = seg_rows.shape
    if not 1 <= nin <= 4:
        raise ValueError(f"ec_sorted takes 1 to 4 input modes, got {nin}")
    if nseg != tile + 1:
        raise ValueError(f"ec_sorted takes tile + 1 = {tile + 1} segment "
                         f"descriptors per block, got {nseg}")
    rank = factors[0].shape[-1]
    i32, f32 = (torch.int32,), (torch.float32,)
    _build.require(values, "values", shape=(nnz,), dtypes=f32, device=dev)
    _build.require(seg_starts, "seg_starts", shape=(nblocks, nseg + 1),
                   dtypes=i32, device=dev)
    _build.require(seg_rows, "seg_rows", shape=(nblocks, nseg), dtypes=i32,
                   device=dev)
    _build.require(block_to_tile, "block_to_tile", shape=(nblocks,),
                   dtypes=i32, device=dev)
    _build.require(input_indices, "input_indices", shape=(nnz, nin),
                   dtypes=i32, device=dev)
    # bf16 factors are cast to f32 before the kernel, as the TPU wrapper
    # does (mttkrp_sorted.py:191)
    facs = [f.float() for f in factors]
    for j, f in enumerate(facs):
        _build.require(f, f"factors[{j}]", shape=(f.shape[0], rank),
                       dtypes=f32, device=dev)
    out, chunks, partials, smem = _build.item_buffers(
        "sorted", block_to_tile, num_rows=num_rows, tile=tile, rank=rank,
        nin=nin, num_buffers=num_buffers, items=items)
    if nblocks == 0:
        return out
    fptrs = [f.data_ptr() for f in facs] + [0] * (4 - nin)
    _build.launch("ec_sorted", "ec_sorted_launch", _ARGTYPES, dev,
                  values.data_ptr(), seg_starts.data_ptr(),
                  seg_rows.data_ptr(), block_to_tile.data_ptr(),
                  chunks.item_starts.data_ptr(), chunks.item_part.data_ptr(),
                  chunks.split.data_ptr(), input_indices.data_ptr(), *fptrs,
                  out.data_ptr(), partials.data_ptr(), nin, nblocks,
                  chunks.split.shape[1], nblocks, block_p, tile, rank,
                  num_buffers, _build.copy_width(facs), smem)
    return out
