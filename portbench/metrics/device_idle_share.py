"""The share of an update in which nothing ran on the device: the device's
busy time a profiled update, over the mean update's time between the CUDA
events of the window (unprofiled, so the profiler's cost to the host's
issue does not stretch it)."""


def read(trace):
    if trace.profile is None or not trace.profile["events"] or not trace.updates:
        return None
    busy_ms = 1e3 * trace.profile["busy_s"] / trace.profile["updates"]
    update_ms = sum(update for update, _ in trace.updates) / len(trace.updates)
    return 100.0 * (1.0 - busy_ms / update_ms)
