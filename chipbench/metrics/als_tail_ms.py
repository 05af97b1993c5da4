"""als_tail_ms: milliseconds a traced sweep and its fit read take outside
the EC stage and the exchange's copies: the solve (``eigh`` and its
synchronise), grams, normalisation and fit, and the host's dispatch
between them. The traced sweep's ``ec`` spans end in a synchronise, so
their host length is the EC stage's; the port's ``exchange`` span also
holds the solve, so only the exchange's copies are taken off."""
from chipbench import profile


def read(r):
    ev = r.traced
    steps = [(e.t0, e.t1) for e in ev if e.name.startswith("step ")
             and e.cat in profile.HOST_SCOPES]
    ec = profile.host_intervals(ev, "ec")
    if not steps or not ec:
        return None
    ns = sum(b - a for a, b in steps) - sum(b - a for a, b in ec)
    if r.num_devices > 1:
        ns -= profile.busiest_card_within(ev, "exchange",
                                          cats={"gpu_memcpy"},
                                          names=("DtoD", "PtoP")) or 0
    return ns / 1e6 / r.traced_sweeps
