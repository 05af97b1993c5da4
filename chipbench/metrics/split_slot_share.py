"""split_slot_share: the share of the EC's placed slots that lie on its
split path, in %: 100 × the mean over the tensor's modes of the program's
gauges ``ec.split_slot_share.mode<d>``, read from the registry as it stood
after the untraced profiled sweeps (``Readings.registry``). ``api.compile``
sets each gauge on the resident plan it places: the slots of the mode's
shards whose block lies in a tile's run of more than ``CHUNK_BLOCKS``
blocks (``_build.split_slots``), which the EC cuts into work items that
write partials for ``ec_combine`` to add, over the slots placed.

The mean is unweighted, as ``walked_slot_share``'s is: a mode whose every
run is split reads 100 whatever its size. None where a mode has no gauge,
as on a program that sets none."""


def read(r):
    gauges = r.registry["gauges"]
    shares = [gauges.get(f"ec.split_slot_share.mode{d}")
              for d in range(len(r.shape))]
    if None in shares:
        return None
    return 100 * sum(shares) / len(shares)
