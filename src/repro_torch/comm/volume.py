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
modelled ones.
"""
from __future__ import annotations

import numpy as np

__all__ = ["wire_bytes", "mode_exchange_bytes", "modelled_exchange_bytes",
           "count_sent", "reset_sent_bytes", "sent_bytes"]

_WIRE_BYTES = {"float32": 4, "bfloat16": 2, None: 4}

# (kind, logical device) -> bytes sent; kind is "gather" or "merge"
_SENT: dict[tuple[str, int], int] = {}


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
    stray = sorted({d for _, d in _SENT if not 0 <= d < num_devices})
    if stray:
        raise ValueError(f"bytes counted for devices {stray} outside a "
                         f"mesh of {num_devices}")

    def kinds(d):
        g, m = _SENT.get(("gather", d), 0), _SENT.get(("merge", d), 0)
        return {"gather_bytes": g, "merge_bytes": m, "total_bytes": g + m}

    return [kinds(d) for d in range(num_devices)]
