"""``ec_blocked``: tile-accumulator EC over rows gathered before the kernel.

Replaces the TPU kernel ``ec_blocked`` (src/repro/kernels/mttkrp_pallas.py:66,
body ``_ec_kernel`` :42-63) with a CUDA kernel written for Hopper,
``ec_blocked_launch`` in ``csrc/ec_onehot.cu`` (shared with ``ec_fused``).

What it computes. The caller gathers each input mode's factor rows into an
``(nnz, R)`` array first (``index_select``, as the reference gathers with
XLA outside its kernel, ops.py:138). Per kernel block the kernel forms
``e = val ⊙ Π rows`` in f32 (bf16 rows are cast inside) and adds each slot's
products into row ``row_in_tile`` of its block's ``(tile, R)`` output tile,
which starts from zero where ``block_to_tile`` changes.

What bounds it on the H100. Bytes: per slot a value, a row index and
``nin`` pre-gathered rows of ``R`` elements, against ``(nin + 1)·R`` flops.
The least time is every input read once and the output written once, over
3.35 TB/s — the gathered rows make it ``R`` times the index traffic of
``ec_fused``, which is why the reference built the fused variant.

What the design does about it. As in ``ec_fused``: one CUDA block per run of
consecutive blocks of a tile, the ``(tile, R)`` accumulator in shared
memory, the products staged with coalesced loads and added by one thread
per column in slot order; no one-hot product, no atomics.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mttkrp_fused import check_onehot_args, onehot_rows
from repro_torch.kernels.ref import ec_rows_ref

__all__ = ["ec_blocked", "ec_blocked_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]
_ROW_DTYPES = (torch.float32, torch.bfloat16)


def ec_blocked(
    values: torch.Tensor,                 # (nnz,)  nnz = nblocks * block_p
    row_in_tile: torch.Tensor,            # (nnz,) int32 in [0, tile)
    block_to_tile: torch.Tensor,          # (nblocks,) int32
    gathered_rows: Sequence[torch.Tensor],  # each (nnz, R)
    *,
    num_rows: int,                        # rows_max (multiple of tile)
    tile: int,
    block_p: int,
) -> torch.Tensor:
    """Blocked EC: returns (num_rows, R) f32.

    CPU tensors take :func:`ec_blocked_plain`; CUDA tensors launch the
    kernel, or raise."""
    check_onehot_args(values, row_in_tile, num_rows=num_rows, tile=tile,
                      block_p=block_p)
    if values.device.type == "cpu":
        return ec_blocked_plain(values, row_in_tile, block_to_tile,
                                gathered_rows, num_rows=num_rows, tile=tile,
                                block_p=block_p)
    if values.device.type != "cuda":
        raise ValueError(f"ec_blocked runs on cpu or cuda tensors, got "
                         f"{values.device}")
    return _launch(values, row_in_tile, block_to_tile, gathered_rows,
                   num_rows=num_rows, tile=tile, block_p=block_p)


def ec_blocked_plain(values, row_in_tile, block_to_tile, gathered_rows, *,
                     num_rows: int, tile: int, block_p: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ec_blocked`, on any device."""
    rows = onehot_rows(row_in_tile, block_to_tile, tile=tile, block_p=block_p)
    return ec_rows_ref(values, gathered_rows, rows, num_rows)


def _launch(values, row_in_tile, block_to_tile, gathered_rows, *, num_rows,
            tile, block_p):
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
    # a bf16 value slab is cast to f32 here (exact, nnz elements); the
    # (nnz, R) rows are cast inside the kernel, as on the TPU
    # (mttkrp_pallas.py:57)
    if values.dtype == torch.bfloat16:
        values = values.float()
    _build.require(values, "values", shape=(nnz,), dtypes=(torch.float32,),
                   device=dev)
    _build.require(row_in_tile, "row_in_tile", shape=(nnz,),
                   dtypes=(torch.int32,), device=dev)
    _build.require(block_to_tile, "block_to_tile", shape=(nblocks,),
                   dtypes=(torch.int32,), device=dev)
    for j, g in enumerate(gathered_rows):
        _build.require(g, f"gathered_rows[{j}]", shape=(nnz, rank),
                       dtypes=(dtype,), device=dev)
    out, runs, smem = _build.launch_buffers(
        "blocked", block_to_tile, num_rows=num_rows, tile=tile,
        block_p=block_p, rank=rank)
    if nblocks == 0:
        return out
    gptrs = [g.data_ptr() for g in gathered_rows] + [0] * (4 - nin)
    fn = _build.kernel_function("ec_onehot", "ec_blocked_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), row_in_tile.data_ptr(),
                 block_to_tile.data_ptr(), runs.data_ptr(), *gptrs,
                 out.data_ptr(), nin, int(dtype == torch.bfloat16), nblocks,
                 block_p, tile, rank, smem, _build.cuda_stream(dev))
    _build.check(err, "ec_onehot", "ec_blocked")
    _build.LAUNCHES["ec_blocked"] += 1
    return out
