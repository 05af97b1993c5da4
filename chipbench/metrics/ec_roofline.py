"""ec_roofline: the least time the cell's cards could take for a sweep's
EC (:func:`chipbench.roofline.ec_sweep_bound_s`, counted from the tensor)
over the EC's device time a sweep on the busiest card (as ``ec_ms``), in
per cent of the published peaks at 700 W."""
from chipbench import profile, roofline


def read(r):
    ns = profile.busiest_card_within(r.traced, "ec")
    if not ns:
        return None
    bound_s, _ = roofline.ec_sweep_bound_s(r.shape, r.rows_used, r.nnz,
                                           r.rank, r.cards)
    return 100.0 * bound_s / (ns / 1e9 / r.traced_sweeps)
