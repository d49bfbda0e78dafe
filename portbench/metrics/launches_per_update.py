"""Device kernels a profiled update (copies and fills not counted)."""

from portbench.profiling import is_kernel


def read(trace):
    if trace.profile is None or not trace.profile["events"]:
        return None
    kernels = sum(1 for name, _, _ in trace.profile["events"] if is_kernel(name))
    return kernels / trace.profile["updates"]
