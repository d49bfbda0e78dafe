"""CartPole-v1 over ``[B]`` tensors (counterpart of
``asyncrl_tpu/envs/cartpole.py``): gymnasium's cart-pole dynamics (Euler
integration, tau=0.02), 2 actions, a 500-step time limit, terminated once
``|x| > 2.4`` or ``|theta| > 12 degrees``. The observation is the physics
state ``[x, x_dot, theta, theta_dot]``; every step's reward is 1.

The random values of a step are the fresh episode an auto-reset starts,
drawn for every env each step as :class:`CartPoleDraws`, so a test can hand
in the states the JAX step drew.

Rounding follows the jitted JAX step on the CPU: XLA folds the divisions by
the total mass into products with ``r = f32(1 / f32(1.1))`` and
``f32(f32(0.1) * r)``, and contracts the force term, both
accelerations' differences and the four Euler updates into fused
multiply-adds, which the port writes as ``fma_f32``. Given the same ``sin``
and ``cos`` the step rounds as the jitted JAX step does; each library's own
``sin`` and ``cos`` differ in the last ulp for a few percent of angles.
The thresholds are Python floats compared against f32 tensors, so they
compare in f32, as JAX's weakly typed constants do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from asyncrl_tpu_torch.envs.core import Environment, EnvSpec, TimeStep
from asyncrl_tpu_torch.utils.numerics import fma_f32

GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
HALF_POLE_LENGTH = 0.5
POLE_MASS_LENGTH = MASS_POLE * HALF_POLE_LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360  # ~0.2095 rad
X_THRESHOLD = 2.4
MAX_STEPS = 500
INIT_BOUND = 0.05

# The constants XLA folds the step's divisions into (f32 arithmetic).
_INV_TOTAL_MASS = float(np.float32(1.0) / np.float32(TOTAL_MASS))
_POLE_OVER_TOTAL = float(np.float32(MASS_POLE) * np.float32(_INV_TOTAL_MASS))
_FOUR_THIRDS = float(np.float32(4.0 / 3.0))


@dataclasses.dataclass
class CartPoleState:
    phys: torch.Tensor  # [B, 4] f32: x, x_dot, theta, theta_dot
    t: torch.Tensor  # [B] int32 step count within the episode


class CartPoleDraws(NamedTuple):
    """The fresh episode of an auto-reset: the reset uniforms."""

    phys: torch.Tensor  # [B, 4] f32 in [-INIT_BOUND, INIT_BOUND)


def physics(phys: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One Euler step of ``[B, 4]`` states under ``[B]`` actions (1 pushes
    right, anything else left)."""
    x, x_dot, theta, theta_dot = phys.unbind(-1)

    def const(v: float) -> torch.Tensor:
        return torch.full_like(x, v)

    force = torch.where(action == 1, const(FORCE_MAG), const(-FORCE_MAG))
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    # temp = (force + ml * theta_dot^2 * sin) / M, the sum one fma.
    pushed = fma_f32(theta_dot * theta_dot * POLE_MASS_LENGTH, sin_t, force)
    temp = pushed * _INV_TOTAL_MASS
    # theta_acc's numerator g * sin - cos * temp and the bracket of its
    # denominator 4/3 - (m / M) * cos^2, one fma each, in one call.
    num, bracket = fma_f32(
        torch.stack([sin_t, -(cos_t * cos_t)]),
        torch.stack([const(GRAVITY), const(_POLE_OVER_TOTAL)]),
        torch.stack([-(cos_t * temp), const(_FOUR_THIRDS)]),
    )
    theta_acc = num / (bracket * HALF_POLE_LENGTH)
    # x_acc = temp - ml * theta_acc * cos / M, with temp's product unrounded.
    x_acc = fma_f32(
        pushed, const(_INV_TOTAL_MASS),
        -(theta_acc * POLE_MASS_LENGTH * cos_t * _INV_TOTAL_MASS),
    )
    # The four Euler updates state + tau * rate, one fma each.
    rates = torch.stack([x_dot, x_acc, theta_dot, theta_acc], dim=-1)
    return fma_f32(rates, torch.full_like(rates, TAU), phys)


class CartPole(Environment):
    """CartPole-v1 over a batch: 4-dim observation, 2 actions."""

    spec = EnvSpec(obs_shape=(4,), num_actions=2)

    def fresh(self, draws: CartPoleDraws) -> CartPoleState:
        t = torch.zeros(draws.phys.shape[:1], dtype=torch.int32, device=draws.phys.device)
        return CartPoleState(phys=draws.phys, t=t)

    def init(self, batch, generator, device) -> CartPoleState:
        return self.fresh(self.draw(batch, generator, device))

    def draw(self, batch, generator, device) -> CartPoleDraws:
        phys = torch.empty((batch, 4), dtype=torch.float32, device=device)
        return CartPoleDraws(phys.uniform_(-INIT_BOUND, INIT_BOUND, generator=generator))

    def observe(self, state: CartPoleState) -> torch.Tensor:
        return state.phys

    def step(self, state: CartPoleState, action: torch.Tensor, draws: CartPoleDraws):
        phys = physics(state.phys, action)
        t = state.t + 1
        terminated = (phys[:, 0].abs() > X_THRESHOLD) | (phys[:, 2].abs() > THETA_THRESHOLD)
        truncated = (t >= MAX_STEPS) & ~terminated
        done = terminated | truncated
        new_phys = torch.where(done[:, None], draws.phys, phys)
        new_state = CartPoleState(phys=new_phys, t=torch.where(done, torch.zeros_like(t), t))
        ts = TimeStep(
            obs=new_phys,
            reward=torch.ones_like(phys[:, 0]),
            terminated=terminated,
            truncated=truncated,
            last_obs=phys,
        )
        return new_state, ts
