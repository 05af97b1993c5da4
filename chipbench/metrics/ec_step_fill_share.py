"""ec_step_fill_share: the share of the lane groups of ``ec_sorted``'s
steps that hold a slot, in %: 100 × the mean over the tensor's modes of
the program's gauges ``ec.step_fill_share.mode<d>``, read from the
registry as it stood after the untraced profiled sweeps
(``Readings.registry``). ``api.compile`` sets each gauge on the resident
plan it places: the slots the kernel walks on the mode's shards
(``_build.walked_slots``) over the lane-group positions of the steps it
walks them in (``_build.step_slots``: each work item in steps of
``_build.step_width(R)`` slots, its last step as wide as the others). It
falls where items end raggedly, as short Zipf tiles' do.

The mean is unweighted, as ``walked_slot_share``'s. None where a mode has
no gauge, as on a program that sets none."""


def read(r):
    gauges = r.registry["gauges"]
    shares = [gauges.get(f"ec.step_fill_share.mode{d}")
              for d in range(len(r.shape))]
    if None in shares:
        return None
    return 100 * sum(shares) / len(shares)
