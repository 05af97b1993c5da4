"""device_idle_pct: the share of the untraced profiled window in which a
card runs no kernel, copy or memset, the mean over the cell's cards."""
from chipbench import profile


def read(r):
    ev = r.untraced
    found = profile.cards(ev)
    if not found:
        return None
    w0, w1 = profile.window(ev)
    busy = [sum(b - a for a, b in profile.busy(ev, c)) for c in found]
    return 100.0 * (1.0 - sum(busy) / len(busy) / (w1 - w0))
