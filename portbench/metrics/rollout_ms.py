"""Device milliseconds of an update's rollout (``Learner.collect``: the
unroll's env steps, renders, actor forwards and samples), between CUDA
events around it, the mean over every update of the traced window."""


def read(trace):
    if not trace.updates:
        return None
    return sum(collect for _, collect in trace.updates) / len(trace.updates)
