"""ec_items_placed_share: the share of the EC's launches that were given
their shard's placed work items, in %: 100 × Δplaced / (Δplaced + Δbuilt)
over the program's counters ``ec.items.placed`` and ``ec.items.built``,
between the registry as it stood before the untraced profiled sweeps
(``Readings.registry_start``) and after them (``Readings.registry``).
Every EC launch raises one of the two (``kernels/_build.count_items``): a
launch given the items ``DeviceArrays.items`` carries (placed with the
shard) counts as placed, one that builds them (``_build.tile_chunks``)
as built. None where neither counter moved, as on a program that counts
neither."""


def read(r):
    def rise(name):
        return (r.registry["counters"].get(name, 0)
                - r.registry_start["counters"].get(name, 0))

    placed, built = rise("ec.items.placed"), rise("ec.items.built")
    if placed + built == 0:
        return None
    return 100 * placed / (placed + built)
