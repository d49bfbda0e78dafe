"""The fused V-trace tail's (B1, ``csrc/fused_vtrace.cu``) share of its
roofline: the least time its bytes take at the card's HBM bandwidth (the
fragment's ``[T, B]`` once an update, however many launches it is split
into) over its device time in the profiled updates."""

from portbench import flops

KERNEL = "fused_vtrace"


def read(trace):
    if trace.profile is None or trace.peaks is None:
        return None
    device_ns = sum(d for name, _, d in trace.profile["events"] if KERNEL in name)
    if not device_ns:
        return None
    cfg = trace.config
    bound_s = (flops.vtrace_bytes(cfg.unroll_len, cfg.num_envs) * trace.profile["updates"]
               / trace.peaks["hbm_bytes"])
    return 100.0 * bound_s / (device_ns / 1e9)
