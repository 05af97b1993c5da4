"""``ec_fused``: tile-accumulator EC with the factor gather in the kernel.

Replaces the TPU kernel ``ec_fused`` (src/repro/kernels/mttkrp_fused.py:128,
body ``_fused_kernel`` :53-125) with a CUDA kernel written for Hopper,
``csrc/ec_fused.cu``.

What it computes. Per kernel block: gather ``nin`` factor rows per nonzero
in the kernel, form ``e = val ⊙ Π rows`` in f32 and add each slot's products
into row ``row_in_tile`` of its block's ``(tile, R)`` output tile. No
``(nnz, R)`` gathered intermediate exists. Order of the sums: as
``ec_sorted``'s — slot order within a tile's run of at most
``_build.CHUNK_BLOCKS`` blocks, and for a longer run per-chunk partials in
slot order added in chunk order (``ref.ec_rows_chunked``); bitwise that of
:func:`ec_fused_plain` on the CPU.

What bounds it on the H100. Bytes, as for ``ec_sorted``: a value, ``nin``
indices, a row index and ``nin`` factor rows per slot against
``(nin + 1)·R`` flops. The least time is every input read once and the
output written once, over 3.35 TB/s.

What the design does about it. On the TPU each block's commit was a
``onehot(row_in_tile)ᵀ @ E`` product on the matrix unit into a
VMEM-resident tile. Here there is no one-hot product (in f32 on tensor
cores it would be TF32; it is pure scatter overhead) and no atomics. Runs
are cut into work items of at most ``CHUNK_BLOCKS`` blocks, one warp each
(``_build.tile_chunks``); the warp fills a ``cp.async`` ring of
``num_buffers`` stages with its slots' factor rows, values and
``row_in_tile``, and adds each slot into a ``(tile, R)`` shared accumulator,
keeping the current row's sum in registers, one lane per column. A split
run's partials are added in item order by ``ec_combine``. ``num_buffers``
changes no bit. What it gives up: strict slot order on runs longer than
``CHUNK_BLOCKS`` blocks.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ec_rows_chunked

__all__ = ["ec_fused", "ec_fused_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 13 + [_I] * 10 + [_P]


def check_onehot_args(values, row_in_tile, *, num_rows, tile, block_p,
                      num_buffers=None):
    """Argument checks shared by ``ec_fused`` and ``ec_blocked``."""
    nnz = values.shape[0]
    _build.check_blocking(nnz, num_rows=num_rows, tile=tile, block_p=block_p,
                          num_buffers=num_buffers)
    if tuple(row_in_tile.shape) != (nnz,):
        raise ValueError(f"row_in_tile has shape {tuple(row_in_tile.shape)},"
                         f" expected {(nnz,)}")


def onehot_rows(row_in_tile, block_to_tile, *, tile: int, block_p: int):
    """Each slot's output row, ``block_to_tile[slot // block_p] * tile +
    row_in_tile[slot]`` — what the one-hot commit addresses."""
    return (block_to_tile.long().repeat_interleave(block_p) * tile
            + row_in_tile.long())


def ec_fused(
    values: torch.Tensor,              # (nnz,)  nnz = nblocks * block_p
    row_in_tile: torch.Tensor,         # (nnz,) int32 in [0, tile)
    block_to_tile: torch.Tensor,       # (nblocks,) int32
    input_indices: torch.Tensor,       # (nnz, nin) int32 rows into factors[w]
    factors: Sequence[torch.Tensor],   # nin tensors (padded_w, R)
    *,
    num_rows: int,                     # rows_max (multiple of tile)
    tile: int,
    block_p: int,
    num_buffers: int = 2,
) -> torch.Tensor:
    """Fused EC: gather + Hadamard + accumulate. Returns (num_rows, R) f32.

    CPU tensors take :func:`ec_fused_plain`; CUDA tensors launch the kernel,
    or raise."""
    check_onehot_args(values, row_in_tile, num_rows=num_rows, tile=tile,
                      block_p=block_p, num_buffers=num_buffers)
    nnz, nin = values.shape[0], len(factors)
    if tuple(input_indices.shape) != (nnz, nin):
        raise ValueError(f"input_indices has shape "
                         f"{tuple(input_indices.shape)}, expected {(nnz, nin)}")
    if values.device.type == "cpu":
        return ec_fused_plain(values, row_in_tile, block_to_tile,
                              input_indices, factors, num_rows=num_rows,
                              tile=tile, block_p=block_p)
    if values.device.type != "cuda":
        raise ValueError(f"ec_fused runs on cpu or cuda tensors, got "
                         f"{values.device}")
    return _launch(values, row_in_tile, block_to_tile, input_indices, factors,
                   num_rows=num_rows, tile=tile, block_p=block_p,
                   num_buffers=num_buffers)


def ec_fused_plain(values, row_in_tile, block_to_tile, input_indices,
                   factors, *, num_rows: int, tile: int,
                   block_p: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ec_fused`, on any device, in the
    kernel's two-level order (``ref.ec_rows_chunked``)."""
    gathered = [f.index_select(0, input_indices[:, j])
                for j, f in enumerate(factors)]
    rows = onehot_rows(row_in_tile, block_to_tile, tile=tile, block_p=block_p)
    return ec_rows_chunked(values, gathered, rows, num_rows, block_to_tile,
                           tile=tile, block_p=block_p,
                           chunk_blocks=_build.CHUNK_BLOCKS)


def _launch(values, row_in_tile, block_to_tile, input_indices, factors, *,
            num_rows, tile, block_p, num_buffers):
    dev = values.device
    nnz, nin = input_indices.shape
    nblocks = nnz // block_p
    if not 1 <= nin <= 4:
        raise ValueError(f"ec_fused takes 1 to 4 input modes, got {nin}")
    rank = factors[0].shape[-1]
    i32, f32 = (torch.int32,), (torch.float32,)
    _build.require(values, "values", shape=(nnz,), dtypes=f32, device=dev)
    _build.require(row_in_tile, "row_in_tile", shape=(nnz,), dtypes=i32,
                   device=dev)
    _build.require(block_to_tile, "block_to_tile", shape=(nblocks,),
                   dtypes=i32, device=dev)
    _build.require(input_indices, "input_indices", shape=(nnz, nin),
                   dtypes=i32, device=dev)
    # bf16 factors are cast to f32 before the kernel, as the TPU wrapper
    # does (mttkrp_fused.py:181)
    facs = [f.float() for f in factors]
    for j, f in enumerate(facs):
        _build.require(f, f"factors[{j}]", shape=(f.shape[0], rank),
                       dtypes=f32, device=dev)
    out, chunks, partials, smem = _build.item_buffers(
        "fused", block_to_tile, num_rows=num_rows, tile=tile, rank=rank,
        nin=nin, num_buffers=num_buffers)
    if nblocks == 0:
        return out
    fptrs = [f.data_ptr() for f in facs] + [0] * (4 - nin)
    fn = _build.kernel_function("ec_fused", "ec_fused_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), row_in_tile.data_ptr(),
                 block_to_tile.data_ptr(), chunks.item_starts.data_ptr(),
                 chunks.item_part.data_ptr(), chunks.split.data_ptr(),
                 input_indices.data_ptr(), *fptrs, out.data_ptr(),
                 partials.data_ptr(), nin, nblocks, chunks.split.shape[1],
                 nblocks, block_p, tile, rank, num_buffers,
                 _build.copy_width(facs), smem, _build.cuda_stream(dev))
    _build.check(err, "ec_fused", "ec_fused")
    _build.LAUNCHES["ec_fused"] += 1
    return out
