"""Trainer of the port (counterpart of ``asyncrl_tpu/api/trainer.py`` on the
Anakin backend): owns the env, the model and the learner, runs the training
loop, greedy evaluation (also in training, every ``eval_every`` calls) and
checkpoints (``utils/checkpoint.py``).

``train()`` keeps each update call's metrics on the device and reads them
back once every ``log_every`` calls (a call runs ``updates_per_call``
updates), so the loop does not wait for the device between reads.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from asyncrl_tpu_torch.config import Config, default_eval_max_steps
from asyncrl_tpu_torch.envs import registry
from asyncrl_tpu_torch.learn.learner import Learner, TrainState, validate_train_target
from asyncrl_tpu_torch.models.networks import build_model
from asyncrl_tpu_torch.ops.distributions import for_spec
from asyncrl_tpu_torch.parallel.mesh import make_mesh
from asyncrl_tpu_torch.utils import checkpoint


def resolve_device(name: str) -> torch.device:
    """The device a config names. CUDA without a GPU raises: the port never
    carries on on the CPU unless asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {name!r}; expected cuda|cpu")
    return device


def make_eval_rollout(env, model, num_episodes: int, max_steps: int):
    """``eval_rollout(generator) -> [num_episodes]`` returns of greedy play
    (the argmax action, or the Gaussian's mean for continuous envs), one
    episode per env, for at most ``max_steps`` steps."""
    dist = for_spec(env.spec)

    @torch.no_grad()
    def eval_rollout(generator: torch.Generator) -> torch.Tensor:
        device = generator.device
        state = env.init(num_episodes, generator, device)
        obs = env.observe(state)
        ret = torch.zeros(num_episodes, device=device)
        alive = torch.ones(num_episodes, device=device)
        for step in range(max_steps):
            dist_params, _ = model(obs)
            state, ts = env.step(
                state, dist.mode(dist_params), env.draw(num_episodes, generator, device)
            )
            ret += ts.reward * alive
            alive *= 1.0 - ts.done.float()
            obs = ts.obs
            # Every episode has ended: the remaining steps add nothing.
            if step % 100 == 99 and not bool(alive.any()):
                break
        return ret

    return eval_rollout


class Trainer:
    """Owns env, model, learner and the training loop. ``env``, ``model``
    and ``mesh`` default to the config's (the model from ``config.seed``,
    the mesh ``make_mesh(config.mesh_shape, config.mesh_axes)`` over the
    config's device); ranks sharing one card are a mesh passed in, e.g.
    ``make_mesh((8,), devices=[torch.device("cuda")] * 8)``.

    Checkpoints: with ``config.checkpoint_dir`` set, the full train state
    and ``env_steps`` are saved there every ``config.checkpoint_every``
    update calls and once when ``train()`` exits, by any path; a directory
    that already holds checkpoints is resumed from its latest step.
    ``restore=path`` starts from the latest checkpoint under ``path``,
    read-only."""

    def __init__(self, config: Config, env=None, model=None, mesh=None, restore=None):
        self.device = resolve_device(config.device)
        self.config = config
        self.env = env if env is not None else registry.make(config.env_id, config)
        if model is None:
            init_gen = torch.Generator().manual_seed(config.seed)
            model = build_model(config, self.env.spec, init_gen)
        self.model = model
        if mesh is None:
            mesh = make_mesh(config.mesh_shape, config.mesh_axes, devices=[self.device])
        self.mesh = mesh
        self.learner = Learner(config, self.env, self.model, mesh)
        self.state: TrainState = self.learner.init_state(config.seed)
        self._ckpt, self.env_steps = checkpoint.setup(config, restore, self.state)
        self.checkpointer = self._ckpt.checkpointer

    def save_checkpoint(self) -> None:
        """Save the current train state now (needs ``checkpoint_dir``)."""
        self._ckpt.save_now(self.state, self.env_steps)

    def close(self) -> None:
        """Release resources (checkpoint writes are synchronous)."""
        self._ckpt.close()

    def train(
        self,
        total_env_steps: int | None = None,
        callback: Callable[[dict[str, Any]], None] | None = None,
    ) -> list[dict[str, Any]]:
        """Run update calls until ``total_env_steps`` env frames are consumed.

        Returns one metrics dict per window of ``log_every`` calls, each with
        ``env_steps``, ``fps`` and ``episode_return`` (the mean over the
        episodes completed in the window), and ``eval_return`` in the windows
        that end with an in-training eval.
        """
        cfg = self.config
        target = total_env_steps or cfg.total_env_steps
        validate_train_target(cfg, target)
        steps_per_call = cfg.batch_steps_per_update * cfg.updates_per_call
        history: list[dict[str, Any]] = []
        pending: list[dict[str, torch.Tensor]] = []
        window_start = time.perf_counter()
        window_steps = 0
        calls = calls_at_eval = 0
        try:
            while self.env_steps < target:
                self.state, metrics = self.learner.update(self.state)
                self.env_steps += steps_per_call
                window_steps += steps_per_call
                calls += 1
                pending.append(metrics)
                self._ckpt.after_update(self.state, self.env_steps)
                if len(pending) < cfg.log_every and self.env_steps < target:
                    continue
                # One read per key; a row is a call's scalar or its [K] stack.
                drained = {
                    k: torch.stack([m[k] for m in pending]).cpu().numpy() for k in pending[0]
                }
                pending = []
                elapsed = time.perf_counter() - window_start
                window_start = time.perf_counter()
                agg = {
                    k: float(np.mean([np.mean(row) for row in v]))
                    for k, v in drained.items() if not k.startswith("episode_")
                }
                count = float(np.sum([np.sum(row) for row in drained["episode_count"]]))
                agg["episode_count"] = count
                for name in ("return", "length"):
                    total = np.sum([np.sum(row) for row in drained[f"episode_{name}_sum"]])
                    agg[f"episode_{name}"] = float(total / max(count, 1.0))
                agg["env_steps"] = self.env_steps
                agg["fps"] = window_steps / max(elapsed, 1e-9)
                window_steps = 0
                # The eval runs on a log boundary, so its time is in no
                # window's fps.
                if cfg.eval_every > 0 and calls - calls_at_eval >= cfg.eval_every:
                    calls_at_eval = calls
                    agg["eval_return"] = self.evaluate(num_episodes=cfg.eval_episodes)
                    self._ckpt.maybe_save_best(self.state, self.env_steps, agg["eval_return"])
                    window_start = time.perf_counter()
                history.append(agg)
                if callback:
                    callback(agg)
        finally:
            # A crash must not lose progress: save what there is.
            self._ckpt.finalize(self.state, self.env_steps)
        return history

    def evaluate(
        self,
        num_episodes: int = 32,
        max_steps: int | None = None,
        seed: int = 1234,
        return_episodes: bool = False,
    ):
        """Mean greedy-policy return over ``num_episodes`` fresh envs
        (``return_episodes=True``: the per-episode returns)."""
        if max_steps is None:
            max_steps = default_eval_max_steps(self.config)
        rollout = make_eval_rollout(self.env, self.state.params, num_episodes, max_steps)
        returns = rollout(torch.Generator(device=self.device).manual_seed(seed))
        if return_episodes:
            return returns.cpu().numpy()
        return float(returns.mean())
