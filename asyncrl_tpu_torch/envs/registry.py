"""Env registry of the port (counterpart of ``asyncrl_tpu/envs/registry.py``),
keyed by the JAX package's env ids."""

from __future__ import annotations

from asyncrl_tpu_torch.envs.cartpole import CartPole
from asyncrl_tpu_torch.envs.core import Environment
from asyncrl_tpu_torch.envs.pendulum import Pendulum
from asyncrl_tpu_torch.envs.pong import Pong, PongPixels


def pong_kwargs(cfg) -> dict:
    """Pong's knobs from a Config (None: the defaults). ``pong_max_steps``
    counts agent decisions; the env counts core steps, hence the scale by
    ``frame_skip``, and the rival re-decides once per agent decision."""
    if cfg is None:
        return {}
    return {
        "opponent": cfg.pong_opponent,
        "opponent_speed": cfg.pong_opponent_speed,
        "max_steps": cfg.pong_max_steps * max(cfg.frame_skip, 1),
        "opponent_every": max(cfg.frame_skip, 1),
    }


def _pixel_kwargs(cfg) -> dict:
    return {} if cfg is None else {"frame_skip": cfg.frame_skip}


_REGISTRY = {
    "CartPole-v1": lambda cfg: CartPole(),
    "JaxPong-v0": lambda cfg: Pong(**pong_kwargs(cfg)),
    "JaxPongPixels-v0": lambda cfg: PongPixels(**pong_kwargs(cfg), **_pixel_kwargs(cfg)),
    "JaxPendulum-v0": lambda cfg: Pendulum(),
}


def make(env_id: str, config=None) -> Environment:
    if env_id not in _REGISTRY:
        raise KeyError(f"unknown env {env_id!r}; registered: {registered()}")
    return _REGISTRY[env_id](config)


def registered() -> list[str]:
    return sorted(_REGISTRY)
