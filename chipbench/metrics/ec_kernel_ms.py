"""ec_kernel_ms: device milliseconds a sweep of the EC's kernels: the work
launched inside the port's ``ec.kernel`` spans of the traced sweeps (the
``ec_<variant>`` call) less the work inside their ``ec.items`` children
(the work items built before each launch, which ``ec_prep_ms`` counts),
on the busiest card. Each of these spans ends in a synchronise of its
card."""
from chipbench import spans


def read(r):
    ns = spans.busiest_self_ns(r.traced, "ec.kernel", ("ec.items",))
    return None if ns is None else ns / 1e6 / r.traced_sweeps
