"""exchange_link_share: the share of NVLink's one-way peak that the
exchange reaches, in %: 100 × the most bytes one card sent a sweep (the
program's ``comm.sent_bytes`` counters over the untraced profiled sweeps)
over ``exchange_ms`` × 450 GB/s (``chipbench/link.py``). A card's peer
copies run on its own stream and every card of the ring sends the same
bytes, so the busiest card's exchange time holds at least one card's
bytes at the peak, and the share cannot pass 100. None on fewer than two
cards or without the counters."""
from chipbench import link


def read(r):
    ms = link.exchange_ms(r)
    sent = link.sent_bytes_per_sweep(r)
    if not ms or sent is None:
        return None
    return 100.0 * sent / (ms / 1e3 * link.NVLINK_BYTES_PER_S)
