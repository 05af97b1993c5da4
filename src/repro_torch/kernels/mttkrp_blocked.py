"""``ec_blocked``: tile-accumulator EC over rows gathered before the kernel.

Replaces the TPU kernel ``ec_blocked`` (src/repro/kernels/mttkrp_pallas.py:66,
body ``_ec_kernel`` :42-63) with a CUDA kernel written for Hopper,
``ec_blocked_launch`` in ``csrc/ec_blocked.cu``, which runs ``ec_fused``'s
item kernel (``csrc/ec_common.cuh``) on pre-gathered rows.

What it computes. The caller gathers each input mode's factor rows into an
``(nnz, R)`` array first (``index_select``, as the reference gathers with
XLA outside its kernel, ops.py:138). Per kernel block the kernel forms
``e = val ⊙ Π rows`` in f32 (bf16 rows are cast to f32 first, exactly) and
adds each slot's products into row ``row_in_tile`` of its block's ``(tile,
R)`` output tile. Order of the sums: ``ec_fused``'s, bit for bit — slot
order within a tile's run of at most ``_build.CHUNK_BLOCKS`` blocks, and
for a longer run per-chunk partials in slot order added in chunk order
(``ref.ec_rows_chunked``); bitwise that of :func:`ec_blocked_plain` on the
CPU.

What bounds it on the H100. Bytes: per slot a value, a row index and
``nin`` pre-gathered rows of ``R`` f32, against ``(nin + 1)·R`` flops. The
least time is every input read once and the output written once, over
3.35 TB/s — the gathered rows make it ``R`` times the index traffic of
``ec_fused``, which is why the reference built the fused variant. Unlike
``ec_fused``'s gathers, these reads are in order and come from device
memory.

What the design does about it. ``ec_fused``'s: runs cut into work items of
at most ``CHUNK_BLOCKS`` blocks (``_build.tile_chunks``), one warp each, so
a hot tile spreads over the SMs; a ``cp.async`` ring of
:data:`RING_DEPTH` stages, each one contiguous stretch of 8 rows of every
input array, plus the values and ``row_in_tile``; a register sum per
column while consecutive slots share a row, a ``(tile, R)`` shared
accumulator between rows; ``ec_combine`` adding a split run's partials in
item order. No one-hot product, no atomics.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp_fused import check_onehot_args, onehot_rows
from repro_torch.kernels.ref import ec_rows_chunked

__all__ = ["ec_blocked", "ec_blocked_plain", "RING_DEPTH"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 12 + [_I] * 10 + [_P]
_ROW_DTYPES = (torch.float32, torch.bfloat16)
# Stages of the cp.async ring (the JAX ec_blocked takes no num_buffers):
# two already keep ~80 KB per SM in flight at the smoke's shape, over 3x what
# 3.35 TB/s needs at ~1 us latency, and a deeper ring costs resident warps.
RING_DEPTH = 2


def ec_blocked(
    values: torch.Tensor,                 # (nnz,)  nnz = nblocks * block_p
    row_in_tile: torch.Tensor,            # (nnz,) int32 in [0, tile)
    block_to_tile: torch.Tensor,          # (nblocks,) int32
    gathered_rows: Sequence[torch.Tensor],  # each (nnz, R)
    *,
    num_rows: int,                        # rows_max (multiple of tile)
    tile: int,
    block_p: int,
    items: torch.Tensor,                  # _build.pack_items(block_to_tile)
) -> torch.Tensor:
    """Blocked EC: returns (num_rows, R) f32.

    CPU tensors take :func:`ec_blocked_plain`; CUDA tensors launch the
    kernel, or raise. ``items`` as in ``ec_sorted``."""
    check_onehot_args(values, row_in_tile, num_rows=num_rows, tile=tile,
                      block_p=block_p)
    _build.count_items(items, values.shape[0] // block_p,
                       values.device)
    if values.device.type == "cpu":
        return ec_blocked_plain(values, row_in_tile, block_to_tile,
                                gathered_rows, num_rows=num_rows, tile=tile,
                                block_p=block_p)
    if values.device.type != "cuda":
        raise ValueError(f"ec_blocked runs on cpu or cuda tensors, got "
                         f"{values.device}")
    return _launch(values, row_in_tile, block_to_tile, gathered_rows,
                   num_rows=num_rows, tile=tile, block_p=block_p, items=items)


def ec_blocked_plain(values, row_in_tile, block_to_tile, gathered_rows, *,
                     num_rows: int, tile: int, block_p: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ec_blocked`, on any device, in the
    kernel's two-level order (``ref.ec_rows_chunked``)."""
    rows = onehot_rows(row_in_tile, block_to_tile, tile=tile, block_p=block_p)
    return ec_rows_chunked(values, gathered_rows, rows, num_rows,
                           block_to_tile, tile=tile, block_p=block_p,
                           chunk_blocks=_build.CHUNK_BLOCKS)


def _launch(values, row_in_tile, block_to_tile, gathered_rows, *, num_rows,
            tile, block_p, items, num_buffers=RING_DEPTH):
    dev = values.device
    nnz, nin = values.shape[0], len(gathered_rows)
    nblocks = nnz // block_p
    if not 1 <= nin <= 4:
        raise ValueError(f"ec_blocked takes 1 to 4 input modes, got {nin}")
    rank = gathered_rows[0].shape[-1]
    dtype = gathered_rows[0].dtype
    if dtype not in _ROW_DTYPES:
        raise TypeError(f"gathered rows have dtype {dtype}, expected f32 or "
                        f"bf16")
    _build.require(values, "values", shape=(nnz,),
                   dtypes=(torch.float32, torch.bfloat16), device=dev)
    _build.require(row_in_tile, "row_in_tile", shape=(nnz,),
                   dtypes=(torch.int32,), device=dev)
    _build.require(block_to_tile, "block_to_tile", shape=(nblocks,),
                   dtypes=(torch.int32,), device=dev)
    for j, g in enumerate(gathered_rows):
        _build.require(g, f"gathered_rows[{j}]", shape=(nnz, rank),
                       dtypes=(dtype,), device=dev)
    # bf16 values and rows are cast to f32 here, exactly (the TPU kernel
    # casts inside, mttkrp_pallas.py:55-57): one ring type for all variants
    values = values.float()
    rows = [g.float() for g in gathered_rows]
    out, chunks, partials, smem = _build.item_buffers(
        "blocked", block_to_tile, num_rows=num_rows, tile=tile, rank=rank,
        nin=nin, num_buffers=num_buffers, items=items)
    if nblocks == 0:
        return out
    gptrs = [g.data_ptr() for g in rows] + [0] * (4 - nin)
    _build.launch("ec_blocked", "ec_blocked_launch", _ARGTYPES, dev,
                  values.data_ptr(), row_in_tile.data_ptr(),
                  block_to_tile.data_ptr(), chunks.item_starts.data_ptr(),
                  chunks.item_part.data_ptr(), chunks.split.data_ptr(), *gptrs,
                  out.data_ptr(), partials.data_ptr(), nin, nblocks,
                  chunks.split.shape[1], nblocks, block_p, tile, rank,
                  num_buffers, _build.copy_width(rows), smem)
    return out
