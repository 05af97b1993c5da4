"""ec_combine_ms: device milliseconds a sweep of the EC's combine, the
kernels whose name holds ``ec_combine`` (which add a split run's partials
into its tile, launched in the same C call as the item kernel) inside the
port's ``ec.kernel`` spans of the traced sweeps, on the busiest card. Each
of these spans ends in a synchronise of its card. 0 where no launch split
a run; None where the window holds no ``ec.kernel`` span or no card's
work."""
from chipbench import profile


def read(r):
    ns = profile.busiest_card_within(r.traced, "ec.kernel",
                                     names=("ec_combine",))
    return None if ns is None else ns / 1e6 / r.traced_sweeps
