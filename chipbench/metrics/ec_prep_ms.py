"""ec_prep_ms: device milliseconds a sweep of the EC's preparation around
its kernels: the work launched inside the port's ``ec.args``
(``kernels/ops.kernel_args``), ``ec.items`` (``kernels/_build.tile_chunks``)
and ``ec.mask`` (the unvisited tiles zeroed) spans of the traced sweeps,
on the busiest card. Each of these spans ends in a synchronise of its
card."""
from chipbench import spans


def read(r):
    ns = spans.busiest_ns(r.traced, ("ec.args", "ec.items", "ec.mask"))
    return None if ns is None else ns / 1e6 / r.traced_sweeps
