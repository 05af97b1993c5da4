"""Factor-exchange collectives (paper §4.9, Algorithm 3) — variant registry.

The counterpart of the reference package's ``comm/collectives.py``. There
the collectives run inside ``shard_map`` on one traced value per device;
here one controller holds the per-device tensors as a list in linear device
order (``g * r + s`` on a ``(group, sub)``
:class:`~repro_torch.core.mttkrp.CPMesh`), and every function takes that
list, the mesh and the mesh axis or axes it runs over, and returns the list
of per-device results. Data moves with
``dst.copy_(src, non_blocking=True)``: a peer copy between two cards, a
device-to-device copy when two logical devices share a card, a plain copy
on the CPU. PyTorch orders a copy between two cards after the work already
queued on both cards' current streams, so no event is needed.

gather (``GATHER_VARIANTS``):

  ``allgather``  every device copies every other device's block straight
                 into its output.
  ``ring``       the paper's explicit ring: M-1 rounds, each device sending
                 to ``(i + 1) mod M`` what it received from ``(i - 1) mod
                 M`` in the round before (Algorithm 3). Each device holds
                 two receive buffers, so round ``z + 1``'s send never reads
                 the buffer that round ``z`` writes.
  ``overlap``    the ring, chunked by rows: chunk ``k + 1``'s rounds are
                 enqueued before chunk ``k``'s received blocks are written
                 into the output.

merge (``MERGE_VARIANTS``, the intra-group reduce for replication r>1):

  ``psum_scatter``  reduce-scatter over the ``sub`` group: member ``s``
                    receives block ``s`` of every other member and sums the
                    ``r`` blocks in member order, ``((p_0 + p_1) + p_2) +
                    ...``: one fixed order, deterministic. (XLA's
                    ``psum_scatter`` fixes its own order; at r = 2 both
                    give the same bits.)
  ``ring_rs``       explicit ring reduce-scatter: each block's partial
                    travels r-1 hops, every hop adding the local
                    contribution — the reference's hop order, so the same
                    bits.

Mixed-precision wire format: with ``wire_dtype`` set (``torch.bfloat16``),
payloads are cast to the wire dtype at the source and back to the input
dtype (fp32) on arrival, merges accumulating in fp32. A bf16-wire merge
always takes the ``ring_rs`` schedule, as in the reference.

Every device's own block also takes the wire round trip, so every replica
ends with the same bits. One device (``M == 1`` or ``r == 1``) is the
identity, with no cast. Each copy between two logical devices adds its
bytes to the sender's count (``repro_torch.comm.volume.sent_bytes``), the
counterpart of the bytes the reference measures in its compiled HLO, and
to the process registry's counter ``comm.sent_bytes.<kind>.dev<k>``
(``repro_torch.obs.get_registry()``), which the registry's readers see.

Selection precedence mirrors ``kernels/ops.py``: explicit argument >
``AMPED_EXCHANGE_VARIANT`` / ``AMPED_EXCHANGE_MERGE`` environment variable
> default (``ring`` / ``psum_scatter``; the legacy ``ring: bool`` flag maps
onto ``ring``/``allgather``). All gather variants are pure data movement
and give the same bits.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch

from repro_torch import obs
from repro_torch.comm import volume

__all__ = [
    "GATHER_VARIANTS", "MERGE_VARIANTS", "ENV_VARIANT", "ENV_MERGE",
    "DEFAULT_VARIANT", "DEFAULT_MERGE", "resolve_variant", "resolve_merge",
    "axis_size", "ring_all_gather", "overlap_all_gather", "all_gather_axes",
    "ring_reduce_scatter", "merge_partials", "default_chunk_rows",
]

GATHER_VARIANTS = ("allgather", "ring", "overlap")
MERGE_VARIANTS = ("psum_scatter", "ring_rs")
ENV_VARIANT = "AMPED_EXCHANGE_VARIANT"
ENV_MERGE = "AMPED_EXCHANGE_MERGE"
DEFAULT_VARIANT = "ring"
DEFAULT_MERGE = "psum_scatter"

# Overlap depth when no chunk size is configured: split the local shard into
# this many chunks (capped so a chunk never goes below one row).
DEFAULT_NUM_CHUNKS = 2

Tensors = Sequence[torch.Tensor]


def resolve_variant(variant: str | None = None,
                    ring: bool | None = None) -> str:
    """Resolve the gather variant (argument > env > legacy flag > default)."""
    if variant is None:
        if ring is not None and ENV_VARIANT not in os.environ:
            return "ring" if ring else "allgather"
        variant = os.environ.get(ENV_VARIANT, DEFAULT_VARIANT)
    if variant not in GATHER_VARIANTS:
        raise ValueError(
            f"unknown exchange variant {variant!r}; expected one of "
            f"{sorted(GATHER_VARIANTS)}")
    return variant


def resolve_merge(merge: str | None = None) -> str:
    """Resolve the merge variant (argument > env > default)."""
    if merge is None:
        merge = os.environ.get(ENV_MERGE, DEFAULT_MERGE)
    if merge not in MERGE_VARIANTS:
        raise ValueError(
            f"unknown exchange merge {merge!r}; expected one of "
            f"{sorted(MERGE_VARIANTS)}")
    return merge


def axis_size(mesh, axis_names) -> int:
    """Devices along ``axis_names`` (one name or a tuple) of ``mesh``."""
    return len(mesh.axis_groups(axis_names)[0])


def default_chunk_rows(rows: int) -> int:
    """Row-chunk size for the ``overlap`` variant when none is configured."""
    return max(1, -(-rows // DEFAULT_NUM_CHUNKS))


def _to_wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    return x if wire_dtype is None else x.to(wire_dtype)


def _send_into(dst: torch.Tensor, src: torch.Tensor, src_id: int,
               kind: str) -> torch.Tensor:
    """Copy ``src`` (held by logical device ``src_id``) into ``dst`` on the
    receiving device: the one place where a payload crosses between
    logical devices, and where its bytes are counted."""
    dst.copy_(src, non_blocking=True)
    nbytes = src.numel() * src.element_size()
    volume.count_sent(kind, src_id, nbytes)
    obs.get_registry().inc(f"comm.sent_bytes.{kind}.dev{src_id}", nbytes)
    return dst


def _send(src: torch.Tensor, src_id: int, device, kind: str) -> torch.Tensor:
    """``src`` copied into a new buffer on ``device``."""
    return _send_into(torch.empty_like(src, device=device), src, src_id,
                      kind)


def ring_all_gather(xs: Tensors, mesh, axis_names, *,
                    wire_dtype=None) -> list[torch.Tensor]:
    """Algorithm 3: explicit ring all-gather over ``axis_names``.

    ``xs[k]`` is device k's ``(chunk, ...)`` block. Returns per device the
    ``(M * chunk, ...)`` gather in linear device order along
    ``axis_names``. With ``wire_dtype`` the payload rides the wire in that
    dtype (one cast at the source: pure data movement)."""
    out = list(xs)
    for ids in mesh.axis_groups(axis_names):
        m = len(ids)
        if m == 1:
            continue  # nothing on the wire — no cast either
        chunk = xs[ids[0]].shape[0]
        wired = [_to_wire(xs[k], wire_dtype) for k in ids]
        gathered = [torch.empty((m * chunk,) + tuple(xs[k].shape[1:]),
                                dtype=xs[k].dtype, device=xs[k].device)
                    for k in ids]
        # two receive buffers per device: round z writes recv[z % 2] while
        # the sends read what round z - 1 wrote into the other one
        recv = [[torch.empty_like(w) for w in wired] for _ in range(2)]
        for i in range(m):
            # the own block takes the wire round trip too, so every replica
            # holds the same bits for every block
            gathered[i][i * chunk:(i + 1) * chunk].copy_(wired[i])
        held = wired
        for z in range(m - 1):
            for i in range(m):
                src = (i - 1) % m
                _send_into(recv[z % 2][i], held[src], ids[src], "gather")
            held = recv[z % 2]
            for i in range(m):
                blk = (i - z - 1) % m  # the block device i now holds
                gathered[i][blk * chunk:(blk + 1) * chunk].copy_(held[i])
        for i, k in enumerate(ids):
            out[k] = gathered[i]
    return out


def _chunk_ring_rounds(chunks: Tensors, ids, wire_dtype) -> list[list]:
    """Enqueue the M-1 ring rounds of one row-chunk. Returns per device its
    ``[(src_index, block), ...]`` in wire dtype, the own block first: the
    copies are issued here, and writing the blocks into the output is the
    caller's consumption step."""
    m = len(ids)
    recv = [_to_wire(c, wire_dtype) for c in chunks]
    parts = [[(i, recv[i])] for i in range(m)]
    for z in range(m - 1):
        recv = [_send(recv[(i - 1) % m], ids[(i - 1) % m], chunks[i].device,
                      "gather") for i in range(m)]
        for i in range(m):
            parts[i].append(((i - z - 1) % m, recv[i]))
    return parts


def overlap_all_gather(xs: Tensors, mesh, axis_names, *,
                       chunk_rows: int | None = None,
                       wire_dtype=None) -> list[torch.Tensor]:
    """Chunked ring all-gather (the ``overlap`` variant).

    Each device's block is split into ``ceil(rows / chunk_rows)`` row
    chunks. Chunk k+1's ring rounds are enqueued before chunk k's received
    blocks are written into the output, so on a card whose copies run
    beside its compute the wire time of chunk k+1 can hide behind chunk k's
    writes. The same bits as :func:`ring_all_gather`: identical data,
    identical layout."""
    out = list(xs)
    for ids in mesh.axis_groups(axis_names):
        m = len(ids)
        if m == 1:
            continue  # nothing on the wire — no cast either
        rows = xs[ids[0]].shape[0]
        cr = default_chunk_rows(rows) if chunk_rows is None else chunk_rows
        cr = max(1, min(int(cr), rows))
        gathered = [torch.empty((m * rows,) + tuple(xs[k].shape[1:]),
                                dtype=xs[k].dtype, device=xs[k].device)
                    for k in ids]

        def consume(base, parts):
            # block from src lands at rows [src*rows + base, + chunk)
            for i in range(m):
                for src, block in parts[i]:
                    lo = src * rows + base
                    gathered[i][lo:lo + block.shape[0]].copy_(block)

        pending = None  # (base_row, parts): the double buffer
        for base in range(0, rows, cr):
            parts = _chunk_ring_rounds(
                [xs[k][base:base + cr] for k in ids], ids, wire_dtype)
            if pending is not None:
                consume(*pending)  # consume k while k+1 is in flight
            pending = (base, parts)
        consume(*pending)
        for i, k in enumerate(ids):
            out[k] = gathered[i]
    return out


def _native_all_gather(xs: Tensors, mesh, axis_names,
                       wire_dtype) -> list[torch.Tensor]:
    """``allgather``: every device copies every block straight into place."""
    out = list(xs)
    for ids in mesh.axis_groups(axis_names):
        m = len(ids)
        if m == 1:
            continue  # nothing on the wire — no cast either
        chunk = xs[ids[0]].shape[0]
        wired = [_to_wire(xs[k], wire_dtype) for k in ids]
        for i, k in enumerate(ids):
            g = torch.empty((m * chunk,) + tuple(xs[k].shape[1:]),
                            dtype=xs[k].dtype, device=xs[k].device)
            for j in range(m):
                blk = wired[j] if j == i else _send(
                    wired[j], ids[j], xs[k].device, "gather")
                g[j * chunk:(j + 1) * chunk].copy_(blk)
            out[k] = g
    return out


def all_gather_axes(xs: Tensors, mesh, axis_names, *,
                    ring: bool | None = None, variant: str | None = None,
                    chunk_rows: int | None = None,
                    wire_dtype=None) -> list[torch.Tensor]:
    """Gather the per-device blocks along ``axis_names`` into the leading
    dim (tiled), via the resolved gather variant. ``ring`` is the legacy
    boolean spelling (True → ``ring``, False → ``allgather``)."""
    variant = resolve_variant(variant, ring)
    if variant == "ring":
        return ring_all_gather(xs, mesh, axis_names, wire_dtype=wire_dtype)
    if variant == "overlap":
        return overlap_all_gather(xs, mesh, axis_names,
                                  chunk_rows=chunk_rows,
                                  wire_dtype=wire_dtype)
    return _native_all_gather(xs, mesh, axis_names, wire_dtype)


def ring_reduce_scatter(xs: Tensors, mesh, sub_axis: str, *,
                        wire_dtype=None) -> list[torch.Tensor]:
    """Explicit ring reduce-scatter over ``sub_axis``: member ``s`` ends
    with rows ``[s*rows/r, (s+1)*rows/r)`` summed across its group. Each
    block's partial travels r-1 hops; every hop casts the payload to
    ``wire_dtype`` for the wire and accumulates in the input dtype."""
    out = list(xs)
    for ids in mesh.axis_groups(sub_axis):
        r = len(ids)
        if r == 1:
            continue
        rows = xs[ids[0]].shape[0]
        if rows % r:
            raise ValueError(
                f"ring_reduce_scatter: leading dim {rows} is not divisible "
                f"by the replication factor r={r}; merged row ownership "
                f"would be corrupted (see core/partition.py rows_max "
                f"padding)")
        chunk = rows // r

        def block(s, b):
            return xs[ids[s]][b * chunk:(b + 1) * chunk]

        # block b's partial starts at member b+1 and ends, fully reduced,
        # at member b after r-1 hops
        acc = [block(s, (s - 1) % r) for s in range(r)]
        for k in range(1, r):
            sent = [_to_wire(a, wire_dtype) for a in acc]
            acc = [_send(sent[(s - 1) % r], ids[(s - 1) % r],
                         xs[ids[s]].device, "merge").to(xs[ids[s]].dtype)
                   + block(s, (s - k - 1) % r) for s in range(r)]
        for s, k in enumerate(ids):
            out[k] = acc[s]
    return out


def _psum_scatter(xs: Tensors, mesh, sub_axis: str) -> list[torch.Tensor]:
    """Reduce-scatter over ``sub_axis``, summing in member order."""
    out = list(xs)
    for ids in mesh.axis_groups(sub_axis):
        r = len(ids)
        chunk = xs[ids[0]].shape[0] // r
        for s, k in enumerate(ids):
            acc = None
            for t in range(r):
                blk = xs[ids[t]][s * chunk:(s + 1) * chunk]
                if t != s:
                    blk = _send(blk, ids[t], xs[k].device, "merge")
                acc = blk if acc is None else acc + blk  # r >= 2 adds
            out[k] = acc
    return out


def merge_partials(partials: Tensors, mesh, sub_axis: str | None, *,
                   merge: str | None = None,
                   wire_dtype=None) -> list[torch.Tensor]:
    """Intra-group merge for replication r: reduce-scatter over the ``sub``
    axis so member ``s`` keeps rows ``[s*rows/r, (s+1)*rows/r)``. Identity
    when r == 1 (the paper's zero-communication case). A bf16 wire always
    takes the ``ring_rs`` schedule."""
    if sub_axis is None:
        return list(partials)
    merge = resolve_merge(merge)
    r = axis_size(mesh, sub_axis)
    if r == 1:
        return list(partials)
    if partials[0].shape[0] % r:
        raise ValueError(
            f"merge_partials: padded row count {partials[0].shape[0]} is "
            f"not divisible by the replication factor r={r} — the reduce-"
            f"scatter would assign fractional row ownership and corrupt the "
            f"merged factor. Plans built by core/partition.py pad rows_max "
            f"to a multiple of lcm(tile, r); rebuild the plan instead of "
            f"hand-crafting the geometry.")
    if merge == "ring_rs" or wire_dtype is not None:
        return ring_reduce_scatter(partials, mesh, sub_axis,
                                   wire_dtype=wire_dtype)
    return _psum_scatter(partials, mesh, sub_axis)
