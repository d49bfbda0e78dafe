"""The whole update's share of the card's bf16 dense peak: the model FLOPs
of an env step (``flops.flops_per_env_step``) times the env steps of the
traced window, over its seconds on the host's clock."""


def read(trace):
    if trace.peaks is None or not trace.window.seconds:
        return None
    rate = trace.flops_per_env_step * trace.window.env_steps / trace.window.seconds
    return 100.0 * rate / trace.peaks["bf16_flops"]
