"""exchange_ms: device milliseconds a sweep of the work launched inside
the port's ``exchange`` spans (each mode's merge and gather, which end in
a synchronise of every card) in the traced sweeps, on the busiest card:
its peer copies out and the copies of the gathered blocks into place
(``chipbench/link.py``). None on fewer than two cards."""
from chipbench import link


def read(r):
    return link.exchange_ms(r)
