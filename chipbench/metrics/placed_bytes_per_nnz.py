"""placed_bytes_per_nnz: the bytes of every placed shard
(``CPSolver.dev_arrays``, all modes and devices) over the tensor's
nonzeros."""


def read(r):
    return r.placed_bytes / r.nnz
