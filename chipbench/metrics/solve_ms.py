"""solve_ms: host milliseconds a sweep of the port's ``solve`` spans in
the traced sweeps (``core/als._solve`` on each replica: the Hadamard of
the grams, ``_pinv_psd``'s ``eigh`` and its synchronise, the product, the
normalisation and the gram), each ending in a synchronise of its card."""
from chipbench import spans


def read(r):
    ns = spans.host_ns(r.traced, "solve")
    return None if ns is None else ns / 1e6 / r.traced_sweeps
