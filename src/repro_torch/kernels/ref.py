"""Plain PyTorch oracles for the MTTKRP elementwise computation (EC).

The counterpart of the reference package's ``kernels/ref.py``. These define
the semantics every EC kernel must match:

    out[row] += val * prod_{w != mode} F_w[idx_w, :]

with rows already local (padded ownership layout, see core/partition.py).

Accumulation order. :func:`ec_rows_ref` uses *slot order*: ``e`` is formed
as ``((val * rows_0) * rows_1) ...`` in f32 and added into its output row
with ``index_add_`` in the order of the slots. On a CPU tensor
``index_add_`` walks the indices in order, so the result is bitwise that of
the reference's ``segment_sum`` (held by the tests). On a CUDA tensor its
default algorithm uses atomics, whose order changes from run to run; so
every ``index_add_`` here runs through :func:`slot_order_index_add`, which
on the card calls what ``index_add_`` calls under
``torch.use_deterministic_algorithms(True)`` — ``index_put_`` with
``accumulate=True``, a stable sort of the indices, then each row's terms
added in sorted order: slot order — without setting that process-wide
switch, which would also change what other threads' operations do (a
cuBLAS product raises under it). The callers set no flag.

:func:`ec_rows_chunked` computes the same function in the fixed two-level
order of the CUDA kernels: a tile's run of at most ``chunk_blocks`` blocks
in slot order (the same bits as slot order), a longer run as per-chunk
partials in slot order, then added in chunk order.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["ec_rows_ref", "ec_rows_chunked", "mttkrp_local_ref",
           "mttkrp_dense_ref", "slot_order_index_add"]


def slot_order_index_add(out: torch.Tensor, index: torch.Tensor,
                         src: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, src)`` with each row's terms added in
    slot order, on every device. A CPU tensor already does so. On a CUDA
    tensor this is ``out.index_put_((index,), src, accumulate=True)``, the
    call ``index_add_`` makes under ``torch.use_deterministic_algorithms``
    (the same sort-based kernel, so the same bits), which is deterministic
    with the switch off: no process-wide setting changes, so an operation
    on another thread runs as it would without this call. That kernel adds
    each row's slot-order sum of terms to ``out``: into a zero ``out``, as
    every caller here adds, the CPU's bits."""
    if out.device.type != "cuda":
        return out.index_add_(0, index, src)
    return out.index_put_((index.long(),), src, accumulate=True)


def ec_rows_ref(values: torch.Tensor, gathered_rows: Sequence[torch.Tensor],
                local_rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """EC from already-gathered input rows.

    values: (nnz,); gathered_rows: list of (nnz, R); local_rows: (nnz,) ints
    in [0, num_rows). Returns (num_rows, R) f32 (padding entries have value 0
    → exact no-ops).
    """
    e = _products(values, gathered_rows)
    out = torch.zeros((num_rows, e.shape[1]), dtype=torch.float32,
                      device=e.device)
    return slot_order_index_add(out, local_rows, e)


def _products(values, gathered_rows):
    e = values.float()[:, None]
    for rows in gathered_rows:
        e = e * rows.float()
    return e


def ec_rows_chunked(values: torch.Tensor,
                    gathered_rows: Sequence[torch.Tensor],
                    local_rows: torch.Tensor, num_rows: int,
                    block_to_tile: torch.Tensor, *, tile: int, block_p: int,
                    chunk_blocks: int) -> torch.Tensor:
    """:func:`ec_rows_ref` in the two-level order of the CUDA kernels.
    Runs are maximal stretches of consecutive blocks with equal
    ``block_to_tile`` (each slot's row lies in its block's tile). A run of
    at most ``chunk_blocks`` blocks goes through ``index_add_`` in slot
    order, as in :func:`ec_rows_ref`. A longer run is cut into chunks of
    ``chunk_blocks`` blocks (the last may be shorter): each chunk's slots go
    in slot order into a ``(tile, R)`` partial, and the partials go into the
    tile in chunk order, from 0 — every row of the tile, untouched ones as
    0 + 0 + ... — so ``out[row] = ((0 + p_0) + p_1) + ...``."""
    e = _products(values, gathered_rows)
    out = torch.zeros((num_rows, e.shape[1]), dtype=torch.float32,
                      device=e.device)
    nb = block_to_tile.shape[0]
    if nb == 0:
        return out
    dev = block_to_tile.device
    b2t = block_to_tile.long()
    blocks = torch.arange(nb, device=dev)
    new = torch.ones(nb, dtype=torch.bool, device=dev)
    new[1:] = b2t[1:] != b2t[:-1]
    end = torch.ones(nb, dtype=torch.bool, device=dev)
    end[:-1] = new[1:]
    # each block's run start, and its run end (one past), from both sides
    first = torch.cummax(torch.where(new, blocks, 0), 0).values
    last = torch.where(end, blocks + 1, nb).flip(0).cummin(0).values.flip(0)
    pos = blocks - first
    split = (last - first) > chunk_blocks
    chunk_first = split & (pos % chunk_blocks == 0)
    chunk_id = torch.cumsum(chunk_first, 0) - 1
    slot_split = split.repeat_interleave(block_p)
    direct = ~slot_split
    slot_order_index_add(out, local_rows[direct], e[direct])
    n_chunks = int(chunk_id[-1]) + 1
    if n_chunks == 0:
        return out
    slot_chunk = chunk_id.repeat_interleave(block_p)[slot_split]
    rows = local_rows[slot_split].long()
    partial = torch.zeros((n_chunks * tile, e.shape[1]), dtype=torch.float32,
                          device=dev)
    slot_order_index_add(partial, slot_chunk * tile + rows % tile,
                         e[slot_split])
    dest = (b2t[chunk_first][:, None] * tile
            + torch.arange(tile, device=dev)).reshape(-1)
    return slot_order_index_add(out, dest, partial)


def mttkrp_local_ref(indices: torch.Tensor, values: torch.Tensor,
                     local_rows: torch.Tensor,
                     factors: Sequence[torch.Tensor], mode: int,
                     num_rows: int) -> torch.Tensor:
    """Gather + EC oracle. ``indices``: (nnz, N) in padded layouts;
    ``factors[w]``: (padded_w, R)."""
    gathered = [factors[w].index_select(0, indices[:, w])
                for w in range(len(factors)) if w != mode]
    return ec_rows_ref(values, gathered, local_rows, num_rows)


def mttkrp_dense_ref(dense: torch.Tensor, factors: Sequence[torch.Tensor],
                     mode: int) -> torch.Tensor:
    """Dense MTTKRP oracle (global layout): X_(d) (B ⊙ C ...) via einsum.
    Supports 3..5 modes."""
    n = dense.dim()
    letters = "ijklm"[:n]
    terms = [dense]
    spec_in = [letters]
    for w in range(n):
        if w == mode:
            continue
        terms.append(factors[w])
        spec_in.append(letters[w] + "r")
    spec = ",".join(spec_in) + "->" + letters[mode] + "r"
    return torch.einsum(spec, *terms)
