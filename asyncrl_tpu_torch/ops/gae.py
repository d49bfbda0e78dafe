"""Generalized Advantage Estimation and n-step returns (counterpart of
``asyncrl_tpu/ops/gae.py``).

    delta_t = r_t + gamma_t V_{t+1} - V_t
    A_t     = delta_t + gamma_t * lambda * A_{t+1}

is the reverse affine scan of ``ops/scan.py`` with a_t = gamma_t * lambda
and b_t = delta_t. Inputs are time-major ``[T, B]``; ``discounts`` are
gamma * (1 - done).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from asyncrl_tpu_torch.ops.fused_vtrace import fused_vtrace, fused_vtrace_plain
from asyncrl_tpu_torch.ops.scan import reverse_linear_scan


class GAEOutput(NamedTuple):
    advantages: torch.Tensor  # [T, B]
    returns: torch.Tensor  # [T, B] advantage + value (TD(lambda) targets)


@torch.no_grad()
def gae(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gae_lambda: float = 0.95,
    scan_impl: str = "associative",
    fused: str = "lax",
) -> GAEOutput:
    """GAE advantages and returns, carrying no gradient.

    ``fused``: "lax" runs the elementwise TD errors and the scan
    ``scan_impl``; "auto" / "kernel" / "plain" ride the fused V-trace tail
    (``ops/fused_vtrace.py``, with ``ops/vtrace.py``'s meaning of the three)
    with unit importance weights: delta_t is then the GAE TD error (x 1.0
    keeps every bit), the scan coefficient is ``discounts * gae_lambda``,
    the tail's vs - V is the advantage and its vs the return. Both paths
    compute in float32 and agree bit for bit with ``scan_impl="sequential"``.
    """
    if fused not in ("auto", "kernel", "plain", "lax"):
        raise ValueError(f"unknown fused mode {fused!r}; expected auto|kernel|plain|lax")
    f32 = torch.float32
    rewards, discounts, values, bootstrap_value = (
        x.detach().to(f32).contiguous() for x in (rewards, discounts, values, bootstrap_value)
    )
    if fused != "lax":
        if fused == "kernel" and rewards.device.type != "cuda":
            raise ValueError(f"fused='kernel' needs CUDA tensors, got {rewards.device}")
        tail = fused_vtrace_plain if fused == "plain" else fused_vtrace
        returns, advantages, _ = tail(
            torch.ones_like(rewards), discounts * gae_lambda, rewards, discounts, values,
            bootstrap_value,
        )
        return GAEOutput(advantages=advantages, returns=returns)

    # JAX fences d * V_{t+1} against contraction (mul_no_fma); PyTorch's
    # eager elementwise ops never contract, so plain * then + rounds alike.
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + discounts * values_tp1 - values
    advantages = reverse_linear_scan(discounts * gae_lambda, deltas, impl=scan_impl)
    return GAEOutput(advantages=advantages, returns=advantages + values)


@torch.no_grad()
def n_step_returns(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    scan_impl: str = "associative",
    fused: str = "lax",
) -> torch.Tensor:
    """Discounted n-step returns across the whole fragment (A3C's targets):
    R_t = r_t + d_t R_{t+1} with R_T = ``bootstrap_value``, the lambda=1,
    value-free case of the GAE recurrence. Carries no gradient.

    The bootstrap folds into the last step's reward, r_{T-1} + d_{T-1} *
    bootstrap (JAX fences that product with mul_no_fma; PyTorch's eager
    * then + rounds alike), and the scan solves for x_T = 0. ``fused``:
    "lax" runs the reverse scan ``scan_impl`` (the kernels B2/B3 for
    "kernel"/"kernel_dma"); "auto" / "kernel" / "plain" ride the fused
    V-trace tail with unit weights and zero values, where delta_t is
    (r_t + d_t * 0) - 0 = r_t and the scan coefficient is d_t, and return
    its vs - V.
    """
    if fused not in ("auto", "kernel", "plain", "lax"):
        raise ValueError(f"unknown fused mode {fused!r}; expected auto|kernel|plain|lax")
    f32 = torch.float32
    rewards, discounts, bootstrap_value = (
        x.detach().to(f32).contiguous() for x in (rewards, discounts, bootstrap_value)
    )
    last = rewards[-1] + discounts[-1] * bootstrap_value
    rewards_ext = torch.cat([rewards[:-1], last[None]], dim=0)
    if fused == "lax":
        return reverse_linear_scan(discounts, rewards_ext, impl=scan_impl)
    if fused == "kernel" and rewards.device.type != "cuda":
        raise ValueError(f"fused='kernel' needs CUDA tensors, got {rewards.device}")
    tail = fused_vtrace_plain if fused == "plain" else fused_vtrace
    zeros = torch.zeros_like(rewards_ext)
    _, returns, _ = tail(
        torch.ones_like(rewards_ext), discounts, rewards_ext, discounts, zeros,
        torch.zeros_like(bootstrap_value),
    )
    return returns
