"""compile_s: host seconds of ``api.compile`` (the shards placed on the
cell's devices), ending in a synchronise of every card."""


def read(r):
    return r.compile_s
