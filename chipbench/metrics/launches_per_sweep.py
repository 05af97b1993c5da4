"""launches_per_sweep: the CUDA calls that enqueue device work and begin
inside the port's ``sweep`` scopes of the untraced profiled sweeps, over
the number of those scopes. Counted, as the profiler names them on the
card: ``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ``cudaMemsetAsync``."""
from chipbench import spans

CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                   "cudaMemsetAsync"})


def read(r):
    n, calls = spans.sweeps(r.untraced), spans.runtime_calls(r.untraced,
                                                             CALLS)
    return None if calls is None or not n else calls / n
