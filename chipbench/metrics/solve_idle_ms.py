"""solve_idle_ms: milliseconds a sweep of the untraced profiled sweeps in
which a card runs no kernel, copy or memset while the host is inside a
``solve`` scope of the port (where ``eigh``'s synchronise holds the host),
the mean over the cell's cards, over the window's ``sweep`` scopes."""
from chipbench import spans


def read(r):
    idle, n = spans.idle_ns_per_card(r.untraced, "solve"), \
        spans.sweeps(r.untraced)
    if idle is None or not n:
        return None
    return sum(idle) / len(idle) / 1e6 / n
