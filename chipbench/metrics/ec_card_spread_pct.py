"""ec_card_spread_pct: how far the busiest card's EC outlasts the mean
card's, in %: 100 × (Σ over the traced sweeps' ``ec`` spans of the
busiest card's device work in the span / Σ of the mean card's − 1). Each
span is one mode's EC on every card and ends in a synchronise of them all,
so the exchange after it waits for the slowest card: 0 is an even split.
None on fewer than two cards or without an ``ec`` span."""
from chipbench import profile


def read(r):
    ev = r.traced
    found = profile.cards(ev)
    spans = profile.host_intervals(ev, "ec")
    if r.cards < 2 or len(found) < 2 or not spans:
        return None
    most = mean = 0.0
    for span in spans:
        busy = [profile.busy_within(ev, c, [span]) for c in found]
        most += max(busy)
        mean += sum(busy) / len(busy)
    return None if not mean else 100.0 * (most / mean - 1.0)
