"""plan_s: host seconds of ``api.plan`` on the cell's tensor (the host
clock around the call, in set-up)."""


def read(r):
    return r.plan_s
