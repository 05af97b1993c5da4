"""walked_slot_share: the share of the EC's placed slots that its item
kernel walks, in %: 100 × the mean over the tensor's modes of the
program's gauges ``ec.walked_slot_share.mode<d>``, read from the registry
as it stood after the untraced profiled sweeps (``Readings.registry``).
``api.compile`` sets each gauge on the resident plan it places: the slots
the kernel walks on the mode's shards (``_build.walked_slots``: each work
item up to the stage of its last nonzero value) over the slots placed.
The share moves only where the plan's padding or the kernel's walk
changes.

The mean is unweighted: the gauges carry each mode's share, not its slot
counts, so a mode of few slots weighs as much as a mode of many. None
where a mode has no gauge."""


def read(r):
    gauges = r.registry["gauges"]
    shares = [gauges.get(f"ec.walked_slot_share.mode{d}")
              for d in range(len(r.shape))]
    if None in shares:
        return None
    return 100 * sum(shares) / len(shares)
