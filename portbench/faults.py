"""Faults planted in the system under test, for the calibration of the
limits and the tests that see ``correct`` come out false. Each patches one
function of ``asyncrl_tpu_torch`` for the length of a ``with`` block; the
benchmark's own runs plant none.

- ``unchanged``: the optimizer's step returns the gradient norm and leaves
  the weights and its state as they were.
- ``half_batch``: the loss and gradient of an update over the first half of
  its envs alone, the mean taken over those.
- ``altered_action``: env 0's sampled action replaced by the next one where
  the sample is drawn, at every step.

The exchange between chips does not exist in these one-chip cells.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "altered_action")


@contextlib.contextmanager
def planted(name: str):
    from asyncrl_tpu_torch.learn import learner
    from asyncrl_tpu_torch.ops import distributions

    if name == "unchanged":
        owner, attr = learner._ClipOptimizer, "step"
        original = owner.step

        def replacement(self, params, grads, state):
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))
    elif name == "half_batch":
        owner, attr = learner, "accumulate_grads"
        original = learner.accumulate_grads

        def replacement(config, model, rollout, dist, scale, *args, **kwargs):
            return original(config, model, learner.shard_rollout(rollout, 0, 2), dist, scale,
                            *args, **kwargs)
    elif name == "altered_action":
        owner, attr = distributions, "gumbel_sample"
        original = distributions.gumbel_sample

        def replacement(uniforms, logits):
            actions = original(uniforms, logits).clone()
            actions[0] = (actions[0] + 1) % logits.shape[-1]
            return actions
    else:
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    setattr(owner, attr, replacement)
    try:
        yield
    finally:
        setattr(owner, attr, original)
