"""The A3C, IMPALA and PPO losses and their helpers (counterpart of
``asyncrl_tpu/ops/losses.py``). Functions over time-major ``[T, B, ...]``
tensors returning ``(scalar_loss, metrics)``; metrics are 0-dim tensors
that carry no gradient."""

from __future__ import annotations

import torch

from asyncrl_tpu_torch.ops.distributions import categorical_entropy, categorical_logp
from asyncrl_tpu_torch.ops.gae import n_step_returns
from asyncrl_tpu_torch.ops.vtrace import vtrace

__all__ = [
    "a3c_loss", "categorical_entropy", "categorical_logp", "explained_variance", "impala_loss",
    "ppo_loss",
]


def explained_variance(targets: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """1 - Var(target - V) / Var(target): 1 is a perfect critic, 0 no better
    than the mean, below 0 worse. Near-constant targets report 0."""
    targets = targets.detach()
    predictions = predictions.detach()
    var_t = targets.var(correction=0)
    ev = 1.0 - (targets - predictions).var(correction=0) / torch.clamp(var_t, min=1e-8)
    return torch.where(var_t < 1e-8, torch.zeros_like(ev), ev)


def a3c_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    dist=None,
    scan_impl: str = "associative",
    fused_scan: str = "lax",
    diagnostics: bool = False,
):
    """n-step-return actor-critic loss (A3C): the targets R_t are the
    fragment's discounted returns bootstrapped from V(x_T)
    (:func:`n_step_returns`, with ``fused_scan`` as its ``fused``), the
    advantage is R_t - V_t, and the policy gradient takes it as a constant.
    ``diagnostics`` (``config.introspect``) adds the value head's explained
    variance."""
    returns = n_step_returns(rewards, discounts, bootstrap_value, scan_impl=scan_impl,
                             fused=fused_scan)
    advantages = returns - values
    logp = dist.logp(logits, actions) if dist else categorical_logp(logits, actions)
    pg_loss = -torch.mean(logp * advantages.detach())
    value_loss = 0.5 * torch.mean(torch.square(advantages))
    entropy = torch.mean(dist.entropy(logits) if dist else categorical_entropy(logits))
    loss = pg_loss + value_coef * value_loss - entropy_coef * entropy
    metrics = {
        "pg_loss": pg_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
        "mean_value": values.detach().mean(),
    }
    if diagnostics:
        metrics["explained_variance"] = explained_variance(returns, values)
    return loss, metrics


def impala_loss(
    logits: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    behaviour_logp: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
    dist=None,
    fused_scan: str = "auto",
    diagnostics: bool = False,
    scan_impl: str = "associative",
):
    """V-trace corrected policy gradient + value + entropy loss.
    ``diagnostics`` (``config.introspect``) adds the behaviour-vs-learner KL,
    the c-clip fraction and the value head's explained variance."""
    target_logp = dist.logp(logits, actions) if dist else categorical_logp(logits, actions)
    vt = vtrace(
        behaviour_logp=behaviour_logp,
        target_logp=target_logp,
        rewards=rewards,
        discounts=discounts,
        values=values,
        bootstrap_value=bootstrap_value,
        rho_clip=rho_clip,
        c_clip=c_clip,
        fused=fused_scan,
        scan_impl=scan_impl,
    )
    pg_loss = -torch.mean(target_logp * vt.pg_advantages)
    value_loss = 0.5 * torch.mean(torch.square(vt.vs - values))
    entropy = torch.mean(dist.entropy(logits) if dist else categorical_entropy(logits))
    loss = pg_loss + value_coef * value_loss - entropy_coef * entropy
    metrics = {
        "pg_loss": pg_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
        "rho_clip_frac": vt.rho_clip_frac,
        "mean_value": values.detach().mean(),
    }
    if diagnostics:
        metrics["kl"] = torch.mean((behaviour_logp - target_logp).detach())
        metrics["c_clip_frac"] = vt.c_clip_frac
        metrics["explained_variance"] = explained_variance(vt.vs, values)
    return loss, metrics


def ppo_loss(
    dist_params: torch.Tensor,
    values: torch.Tensor,
    actions: torch.Tensor,
    behaviour_logp: torch.Tensor,
    advantages: torch.Tensor,
    returns: torch.Tensor,
    dist,
    clip_eps: float = 0.2,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    diagnostics: bool = False,
):
    """PPO clipped surrogate + value + entropy loss over precomputed (GAE)
    ``advantages`` and ``returns``, which carry no gradient. Flat or
    ``[T, B]`` batch shapes alike. Advantages are normalised by the batch's
    own moments (one device: the batch is the global batch)."""
    logp = dist.logp(dist_params, actions)
    ratio = torch.exp(logp - behaviour_logp)
    mean = torch.mean(advantages)
    sq_mean = torch.mean(torch.square(advantages))
    std = torch.sqrt(torch.clamp(sq_mean - torch.square(mean), min=0.0))
    advantages = (advantages - mean) / (std + 1e-8)
    unclipped = ratio * advantages
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * advantages
    pg_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = 0.5 * torch.mean(torch.square(returns - values))
    entropy = torch.mean(dist.entropy(dist_params))
    loss = pg_loss + value_coef * value_loss - entropy_coef * entropy
    metrics = {
        "pg_loss": pg_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
        "clip_frac": (torch.abs(ratio - 1.0) > clip_eps).float().mean().detach(),
        "approx_kl": torch.mean(behaviour_logp - logp).detach(),
    }
    if diagnostics:
        metrics["explained_variance"] = explained_variance(returns, values)
    return loss, metrics
