"""The links between the cards and the bytes the exchange sends over them.

The peak is NVIDIA's data sheet for the H100 SXM: NVLink 4 moves 900 GB/s
a card, both directions together, so 450 GB/s in one direction. A peer
copy runs on the sending card's stream, so a card's exchange time is at
least the bytes it sent over that peak.

The bytes are the program's counters ``comm.sent_bytes.<kind>.dev<k>``
(``kind`` ``gather`` or ``merge``), which ``repro_torch.comm.collectives``
raises for every copy from logical device ``k`` to another, read over the
untraced profiled sweeps (``Readings.registry_start`` and ``.registry``).
"""
from __future__ import annotations

from chipbench import profile

__all__ = ["NVLINK_BYTES_PER_S", "PREFIX", "exchange_ms", "untraced_sweeps",
           "sent_bytes_per_sweep"]

NVLINK_BYTES_PER_S = 450e9
PREFIX = "comm.sent_bytes."


def exchange_ms(r) -> float | None:
    """Device milliseconds a sweep of the work inside the port's
    ``exchange`` spans of the traced sweeps, on the busiest card; None on
    fewer than two cards or without the spans."""
    if r.cards < 2:
        return None
    ns = profile.busiest_card_within(r.traced, "exchange")
    return None if ns is None else ns / 1e6 / r.traced_sweeps


def untraced_sweeps(r) -> int:
    """The sweeps of the untraced profiled window: the harness's ``step k``
    scopes."""
    return sum(1 for e in r.untraced if e.cat in profile.HOST_SCOPES
               and e.name.startswith("step "))


def sent_bytes_per_sweep(r) -> float | None:
    """The most bytes one logical device sent a sweep over the untraced
    profiled sweeps, every kind together; None without the counters or
    the sweeps."""
    start, end = r.registry_start["counters"], r.registry["counters"]
    per_dev: dict[str, int] = {}
    for name, v in end.items():
        if name.startswith(PREFIX):
            dev = name.rsplit(".", 1)[1]
            per_dev[dev] = per_dev.get(dev, 0) + v - start.get(name, 0)
    n = untraced_sweeps(r)
    if not per_dev or not n:
        return None
    return max(per_dev.values()) / n
