"""padded_row_share: the rows every replica holds of the factors, as a
share of the tensor's rows, in %: 100 × Σ_d ``partition.padded_rows.mode<d>``
/ Σ_d shape[d]. ``api.compile`` sets each gauge to the mode's padded
factor, ``n_groups × rows_max``: the partition balances nonzeros, not
rows, so each group's block is as tall as the group owning most rows,
and every card holds, solves over and gathers into that many. None on one
device or where a mode has no gauge, as on a program that sets none."""


def read(r):
    gauges = r.registry["gauges"]
    rows = [gauges.get(f"partition.padded_rows.mode{d}")
            for d in range(len(r.shape))]
    if r.num_devices < 2 or None in rows:
        return None
    return 100.0 * sum(rows) / sum(r.shape)
