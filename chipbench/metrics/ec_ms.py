"""ec_ms: device milliseconds a sweep of the work launched inside the
port's ``ec`` spans (the EC stage of the traced sweep, which ends in a
synchronise), whatever kernels carry it, on the busiest card."""
from chipbench import profile


def read(r):
    ns = profile.busiest_card_within(r.traced, "ec")
    return None if ns is None else ns / 1e6 / r.traced_sweeps
