"""The numbers that decide ``correct``: what the system's first updates
produced, against the plain reference that followed them.

- ``env_mismatch``: frames, rewards and episode ends of the recorded
  fragments that differ from the reference's envs stepped with the same
  actions and random values (exact: limit 0).
- ``action_gap``: the widest gap by which a recorded action's logit plus its
  Gumbel noise lies below the best action's, under the reference's logits.
- ``logp_gap``: the widest gap between a recorded behaviour log-prob and
  the reference's; ``first_logp_gap`` the same over the fragments that the
  initial weights acted on, before the first refresh of the actor.
- ``loss_gap``: the widest gap between an update's loss and the
  reference's; ``first_loss_gap`` the first update's, where both sides
  start from the same weights.
- ``grad_gap``: over the leaves, the widest gap between the norm of the
  system's first gradient (as the optimizer took it) and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf.
- ``change_gap``: the same of the weights' change over the updates compared,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (Adam moves those by round-off alone).
"""

from __future__ import annotations

import math
import statistics

import torch

QUIET_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    ref = _norms(reference)
    got = _norms(program)
    floor = statistics.median(ref.values())
    keys = list(ref) if leaves is None else leaves
    return {k: abs(got[k] - ref[k]) / max(ref[k], floor) for k in keys}


def numbers(record: dict, ref: dict, weights: dict, initial_fragments: int) -> dict:
    """The numbers, and ``per_update``: the gaps of each update, which the
    calibration reads."""
    weights = {k: v.cpu() for k, v in weights.items()}
    loss_gaps = [abs(a - b) for a, b in zip(record["losses"], ref["losses"])]
    grad_norms = _norms(ref["first_grads"])
    floor = statistics.median(grad_norms.values())
    moving = [k for k, n in grad_norms.items() if n >= QUIET_LEAF * floor]
    grad_leaves = leaf_gaps(record["first_grads"], ref["first_grads"])
    change_leaves = leaf_gaps({k: v - weights[k] for k, v in record["params_after"].items()},
                              {k: v - weights[k] for k, v in ref["params_after"].items()},
                              moving)
    return {
        "env_mismatch": ref["env_mismatch"],
        "action_gap": max(ref["action_gaps"]),
        "logp_gap": max(ref["logp_gaps"]),
        "first_logp_gap": max(ref["logp_gaps"][:initial_fragments]),
        "loss_gap": max(loss_gaps),
        "first_loss_gap": loss_gaps[0],
        "grad_gap": max(grad_leaves.values()),
        "change_gap": max(change_leaves.values()),
        "per_update": {"action_gaps": ref["action_gaps"], "logp_gaps": ref["logp_gaps"],
                       "loss_gaps": loss_gaps, "grad_leaves": grad_leaves,
                       "change_leaves": change_leaves, "grad_norms": grad_norms},
    }


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for each number, ``{"value", "limit"}``: every number
    limited is present, finite and at most its limit."""
    checks, correct = {}, True
    for name, entry in limits.items():
        value = values.get(name)
        ok = value is not None and math.isfinite(value) and value <= entry["limit"]
        correct = correct and ok
        checks[name] = {"value": value, "limit": entry["limit"]}
    return correct, checks
