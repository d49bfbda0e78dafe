"""Anakin rollout of the port (counterpart of
``asyncrl_tpu/rollout/anakin.py``): ``B`` envs live in device memory and are
stepped together for ``T`` steps.

Where JAX fuses the T steps into one ``lax.scan``, the port runs a Python
loop that writes each step into ``[T, B, ...]`` tensors allocated before
the loop. Each step is a policy forward, a sample (Gumbel-max for discrete
actions, mean + std * normal noise for continuous ones), one batched env
step with auto-reset, and the trajectory write. Random numbers come from
one ``torch.Generator`` on the envs' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from asyncrl_tpu_torch.envs.core import Environment
from asyncrl_tpu_torch.rollout.buffer import EpisodeStats, Rollout


@dataclasses.dataclass
class ActorState:
    """Env states, current observations and the running per-env episode
    accumulators, carried from one fragment to the next."""

    env_state: Any
    obs: torch.Tensor  # [B, *obs_shape]
    running_return: torch.Tensor  # [B] f32
    running_length: torch.Tensor  # [B] f32


def actor_init(
    env: Environment, num_envs: int, generator: torch.Generator, device
) -> ActorState:
    env_state = env.init(num_envs, generator, device)
    zeros = torch.zeros(num_envs, dtype=torch.float32, device=device)
    return ActorState(
        env_state=env_state,
        obs=env.observe(env_state),
        running_return=zeros,
        running_length=zeros.clone(),
    )


@torch.no_grad()
def unroll(
    model,
    env: Environment,
    actor_state: ActorState,
    unroll_len: int,
    generator: torch.Generator,
    dist,
    reward_scale: float = 1.0,
    step_cost: float = 0.0,
) -> tuple[ActorState, Rollout, EpisodeStats]:
    """Roll ``model`` (``obs[B] -> (dist_params[B, P], value[B])``) forward
    ``unroll_len`` steps over the env batch; ``dist`` interprets the policy
    head and says what noise a sample needs. Only the behaviour log-prob is
    kept from the forward: the learner recomputes values under its own
    weights. The fragment's rewards are the learner's view,
    ``(r - step_cost) * reward_scale``; the episode sums stay raw."""
    obs = actor_state.obs
    B, device = obs.shape[0], obs.device
    T = unroll_len

    def buf(dtype, *trailing):
        return torch.empty((T, B, *trailing), dtype=dtype, device=device)

    rollout = Rollout(
        obs=buf(obs.dtype, *obs.shape[1:]),
        actions=buf(dist.action_dtype, *dist.action_shape),
        behaviour_logp=buf(torch.float32),
        rewards=buf(torch.float32),
        terminated=buf(torch.bool),
        truncated=buf(torch.bool),
        bootstrap_obs=obs,  # replaced after the loop
    )
    env_state = actor_state.env_state
    running_return = actor_state.running_return
    running_length = actor_state.running_length
    done_returns = torch.zeros((), device=device)
    done_lengths = torch.zeros((), device=device)
    done_count = torch.zeros((), device=device)
    for t in range(T):
        rollout.obs[t] = obs
        dist_params, _ = model(obs)
        actions = dist.sample(dist.noise(dist_params, generator), dist_params)
        rollout.actions[t] = actions
        rollout.behaviour_logp[t] = dist.logp(dist_params, actions)
        env_state, ts = env.step(env_state, actions, env.draw(B, generator, device))
        rollout.rewards[t] = (ts.reward - step_cost) * reward_scale
        rollout.terminated[t] = ts.terminated
        rollout.truncated[t] = ts.truncated

        done_f = ts.done.float()
        ep_return = running_return + ts.reward
        ep_length = running_length + 1.0
        done_returns += (ep_return * done_f).sum()
        done_lengths += (ep_length * done_f).sum()
        done_count += done_f.sum()
        running_return = ep_return * (1.0 - done_f)
        running_length = ep_length * (1.0 - done_f)
        obs = ts.obs

    rollout.bootstrap_obs = obs
    final = ActorState(
        env_state=env_state,
        obs=obs,
        running_return=running_return,
        running_length=running_length,
    )
    return final, rollout, EpisodeStats(done_returns, done_lengths, done_count)
