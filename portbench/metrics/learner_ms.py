"""Device milliseconds of an update less its rollout (the loss, V-trace,
backward, clip, Adam and the actor refresh), between CUDA events, the mean
over every update of the traced window."""


def read(trace):
    if not trace.updates:
        return None
    return sum(update - collect for update, collect in trace.updates) / len(trace.updates)
