"""Exchange-volume accounting: modelled bytes vs counted bytes.

The model is the reference package's (``comm/volume.py``), the canonical
ring formulas of the paper's §4.9 cost:

* gather — after the intra-group merge each device holds
  ``rows_max / r`` output rows; a ring (or bandwidth-optimal all-gather)
  moves every remote block through every device once, so each device
  **sends** ``(m-1) · rows_max/r · R`` elements per mode update (the
  ``overlap`` variant moves the same bytes, just pipelined).
* merge — a reduce-scatter over the ``r`` group members sends
  ``(r-1) · rows_max/r · R`` elements per device (identity when r = 1,
  the paper's zero-communication case).

With a bf16 wire both terms halve.

The *counted* side replaces the reference's HLO parsing: every copy that
the port's collectives make between two logical devices adds its bytes to
the sending device's count (:func:`count_sent`); :func:`reset_sent_bytes`
zeroes the counts and :func:`sent_bytes` reads them for every logical
device. Where the model holds, each device's counted bytes equal the
modelled ones. :func:`measured_exchange_bytes` reads the counts under the
reference's collective names (its ``by_kind`` / ``total_bytes`` record),
naming each send kind by the collective the reference lowers that
schedule to.
"""
from __future__ import annotations

import numpy as np

__all__ = ["wire_bytes", "mode_exchange_bytes", "modelled_exchange_bytes",
           "count_sent", "reset_sent_bytes", "sent_bytes", "sent_by_kind",
           "EXCHANGE_COLLECTIVES", "collective_kind",
           "measured_exchange_bytes"]

_WIRE_BYTES = {"float32": 4, "bfloat16": 2, None: 4}

# (kind, logical device) -> bytes sent; kind is "gather", "merge" (the CP
# exchange, comm.collectives) or "all_to_all" (models.ffn.moe_a2a)
_SENT: dict[tuple[str, int], int] = {}

# the collectives that carry exchange traffic, by the reference's HLO names
# (an all-to-all is the MoE dispatch's, not the exchange's)
EXCHANGE_COLLECTIVES = ("all-gather", "collective-permute", "reduce-scatter",
                        "all-reduce")


def wire_bytes(wire_dtype: str | None) -> int:
    """Bytes per element on the wire for a named wire dtype."""
    try:
        return _WIRE_BYTES[wire_dtype]
    except KeyError:
        return int(np.dtype(wire_dtype).itemsize)


def mode_exchange_bytes(part, rank: int, *, wire_dtype: str | None = None,
                        ) -> dict:
    """Modelled per-device exchange bytes for one mode update of
    ``part`` (a :class:`~repro_torch.core.partition.ModePartition`)."""
    wb = wire_bytes(wire_dtype)
    m, r = int(part.num_devices), int(part.r)
    gather_rows = part.rows_max // r
    gather = (m - 1) * gather_rows * rank * wb
    merge = (r - 1) * (part.rows_max // r) * rank * wb if r > 1 else 0
    return {"gather_bytes": int(gather), "merge_bytes": int(merge),
            "total_bytes": int(gather + merge)}


def modelled_exchange_bytes(plan, rank: int, *,
                            wire_dtype: str | None = None) -> dict:
    """Modelled per-device exchange bytes for one full ALS sweep of
    ``plan`` (every mode's merge + gather)."""
    per_mode = [mode_exchange_bytes(p, rank, wire_dtype=wire_dtype)
                for p in plan.modes]
    return {
        "wire_dtype": wire_dtype or "float32",
        "per_mode": per_mode,
        "sweep_total_bytes": int(sum(p["total_bytes"] for p in per_mode)),
    }


def count_sent(kind: str, device: int, nbytes: int) -> None:
    """Add ``nbytes`` that logical device ``device`` sent for ``kind``."""
    _SENT[kind, device] = _SENT.get((kind, device), 0) + int(nbytes)


def reset_sent_bytes() -> None:
    _SENT.clear()


def sent_bytes(num_devices: int) -> list[dict]:
    """Bytes that each logical device ``0 .. num_devices - 1`` sent since
    the last reset, per kind and in total (zero where it sent nothing)."""
    stray = sorted({d for k, d in _SENT if k in ("gather", "merge")
                    and not 0 <= d < num_devices})
    if stray:
        raise ValueError(f"bytes counted for devices {stray} outside a "
                         f"mesh of {num_devices}")

    def kinds(d):
        g, m = _SENT.get(("gather", d), 0), _SENT.get(("merge", d), 0)
        return {"gather_bytes": g, "merge_bytes": m, "total_bytes": g + m}

    return [kinds(d) for d in range(num_devices)]


def sent_by_kind(device: int) -> dict:
    """Bytes that logical device ``device`` sent since the last reset, by
    send kind (only the kinds it sent)."""
    return {k: v for (k, d), v in sorted(_SENT.items()) if d == device}


def collective_kind(kind: str, spec=None) -> str:
    """The reference's collective name for a send ``kind`` under ``spec``
    (an ``ExchangeSpec``; default: the default schedule): a ``ring`` or
    ``overlap`` gather and a ``ring_rs`` merge lower to
    ``collective-permute``, an ``allgather`` gather to ``all-gather``, a
    ``psum_scatter`` merge to ``reduce-scatter``, the MoE exchange to
    ``all-to-all``."""
    variant = getattr(spec, "variant", "ring")
    merge = getattr(spec, "merge", "psum_scatter")
    if kind == "gather":
        return "all-gather" if variant == "allgather" else "collective-permute"
    if kind == "merge":
        return "reduce-scatter" if merge == "psum_scatter" \
            else "collective-permute"
    if kind == "all_to_all":
        return "all-to-all"
    raise ValueError(f"unknown send kind {kind!r}")


def measured_exchange_bytes(spec=None, *, device: int | None = None) -> dict:
    """Per-device exchange bytes counted since the last reset, split by the
    reference's collective name, with their sum: the reference's record
    (``by_kind``, ``total_bytes``), read from :func:`count_sent`'s counts
    instead of compiled HLO. ``device``: one logical device (default: the
    one that sent the most exchange bytes). Only
    :data:`EXCHANGE_COLLECTIVES` count."""
    devices = sorted({d for _, d in _SENT}) if device is None else [device]

    def picked(d):
        out: dict[str, float] = {}
        for k, v in sent_by_kind(d).items():
            name = collective_kind(k, spec)
            if name in EXCHANGE_COLLECTIVES:
                out[name] = out.get(name, 0.0) + float(v)
        return out

    by_dev = [picked(d) for d in devices] or [{}]
    best = max(by_dev, key=lambda c: sum(c.values()))
    return {"by_kind": best, "total_bytes": float(sum(best.values()))}
