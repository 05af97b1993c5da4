"""syncs_per_sweep: the CUDA calls that block the host until the card has
run what they wait for, begun inside the port's ``sweep`` scopes of the
untraced profiled sweeps, over the number of those scopes. Counted, as
the profiler names them on the card: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy`` (the
blocking copy)."""
from chipbench import spans

CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def read(r):
    n, calls = spans.sweeps(r.untraced), spans.runtime_calls(r.untraced,
                                                             CALLS)
    return None if calls is None or not n else calls / n
