"""Learner of the port (counterpart of ``asyncrl_tpu/learn/learner.py``, its
A3C, IMPALA and PPO branches for feed-forward models on one device).

One update is what the JAX package fuses into one ``jit``: roll the envs
``unroll_len`` steps forward with the actor weights, then learn from the
fragment. A3C and IMPALA recompute logits and values under the learner
weights, apply the n-step-return or V-trace loss, clip the gradients by
their global norm, take an Adam step at the rate of ``lr_schedule`` and,
for IMPALA every ``actor_staleness`` updates, refresh the actor weights
(A3C's actors always use the newest). The entropy coefficient follows
``entropy_coef_at``. ``Learner.update`` runs ``updates_per_call`` updates
and stacks each metric ``[K]``, as JAX's ``fuse_updates`` does in one
``lax.scan``. PPO with several epochs or minibatches (``_ppo_multipass``)
computes GAE once under the pre-update weights, then takes
``ppo_epochs x ppo_minibatches`` clip + Adam steps on shuffled minibatches
of the flat ``T*B`` samples; its actors always use the newest weights.

On a mesh of n data-parallel ranks (``parallel/mesh.py``) the update is the
JAX ``make_train_step``'s: the envs roll out once, rank r owns the env
columns ``[r*B/n, (r+1)*B/n)``, each rank takes its loss on its shard scaled
by 1/n and the gradient of that, ``reduce_grads`` sums the n gradients
(``config.grad_reduce``: "psum" or the ring kernel), one clip + Adam step
applies the sum, and the metrics are the means over the ranks (JAX's
``pmean``) while the episode sums count every env. The ranks share one
device and run one after the other. One rank is the single-device update.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from asyncrl_tpu_torch.config import resolve_scan_impl
from asyncrl_tpu_torch.envs.core import Environment
from asyncrl_tpu_torch.ops.distributions import for_spec
from asyncrl_tpu_torch.ops.gae import gae
from asyncrl_tpu_torch.ops.losses import a3c_loss, impala_loss, ppo_loss
from asyncrl_tpu_torch.parallel.mesh import (
    canonical_device, dp_axes, dp_size, make_mesh, reduce_grads,
)
from asyncrl_tpu_torch.rollout.anakin import ActorState, actor_init, unroll
from asyncrl_tpu_torch.rollout.buffer import Rollout


@dataclasses.dataclass
class AdamState:
    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class ClipAdam:
    """``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr,
    eps=eps))``, written in optax's own form. ``learning_rate`` is a float
    or a schedule ``count -> rate`` (an f32 value), evaluated at the count
    of steps taken before this one, as optax's ``scale_by_schedule`` does.

    The clip scales by ``max_norm / norm`` once the norm reaches
    ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` would divide by
    ``norm + 1e-6``), and ``eps`` sits outside the square root.
    """

    def __init__(self, learning_rate, max_grad_norm: float, eps: float,
                 b1: float = 0.9, b2: float = 0.999):
        self.lr = learning_rate
        self.max_norm = max_grad_norm
        self.eps = eps
        self.b1 = b1
        self.b2 = b2

    def init(self, params: list[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    def rate(self, count: int) -> float:
        """The rate of the step taken after ``count`` steps."""
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: AdamState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the global norm
        of ``grads`` before clipping (a 0-dim tensor, no host sync)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        lr = self.rate(state.count)
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(state.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(state.count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = torch.where(keep, g, (g / norm) * self.max_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -lr)
        return norm


def total_optimizer_steps(config) -> int:
    """Optimizer steps over a full run: the linear schedule's horizon (JAX
    ``_total_optimizer_steps`` on the Anakin backend). An update consumes
    ``num_envs * unroll_len`` frames and takes one step, or
    ``ppo_epochs * ppo_minibatches`` for PPO."""
    updates = max(1, config.total_env_steps // max(config.batch_steps_per_update, 1))
    if config.algo == "ppo":
        updates *= max(1, config.ppo_epochs) * max(1, config.ppo_minibatches)
    return updates


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """``optax.linear_schedule(init_value, end_value, transition_steps)`` in
    its f32 arithmetic: ``(init - end) * (1 - k / n) + end`` with k the
    step count clipped to [0, n]."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), transition_steps)) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


def make_optimizer(config) -> ClipAdam:
    """Global-norm clip + Adam at ``config.learning_rate``, constant or
    annealed linearly to 0 over the run's optimizer steps."""
    if config.lr_schedule == "constant":
        lr = config.learning_rate
    elif config.lr_schedule == "linear":
        lr = linear_schedule(config.learning_rate, 0.0, total_optimizer_steps(config))
    else:
        raise ValueError(
            f"unknown lr_schedule {config.lr_schedule!r}; expected constant|linear"
        )
    return ClipAdam(lr, config.max_grad_norm, config.adam_eps)


def validate_train_target(config, target: int) -> None:
    """With an annealing LR schedule, training past the configured horizon
    would run at lr=0: refuse instead."""
    if config.lr_schedule != "constant" and target > config.total_env_steps:
        raise ValueError(
            f"train(total_env_steps={target}) exceeds the lr_schedule "
            f"horizon (config.total_env_steps={config.total_env_steps}): "
            "the annealed rate would sit at 0 for the excess steps. Set "
            "config.total_env_steps to the real budget instead."
        )


def entropy_coef_at(config, update_step: int) -> float:
    """The entropy coefficient at ``update_step``: ``entropy_coef`` when
    annealing is off, else the f32 ramp to ``entropy_coef_final`` over
    ``entropy_anneal_steps`` updates, held after it."""
    if config.entropy_anneal_steps <= 0:
        return config.entropy_coef
    f32 = np.float32
    frac = np.clip(f32(update_step) / f32(config.entropy_anneal_steps), f32(0), f32(1))
    return float(f32(config.entropy_coef)
                 + frac * f32(config.entropy_coef_final - config.entropy_coef))


@dataclasses.dataclass
class TrainState:
    """``params`` are the learner weights and ``actor_params`` the stale copy
    the rollout uses (the same module when ``actor_staleness`` is 1)."""

    params: torch.nn.Module
    actor_params: torch.nn.Module
    opt_state: AdamState
    actor: ActorState
    update_step: int
    generator: torch.Generator


def _forward_fragment(model, rollout: Rollout):
    """Learner forward over the stacked ``[T+1, B]`` observations (the last
    entry is the bootstrap step)."""
    obs_all = torch.cat([rollout.obs, rollout.bootstrap_obs[None]], dim=0)
    return model(obs_all)


def _gae(config, rollout: Rollout, values: torch.Tensor):
    """GAE of a fragment from the values of its ``T+1`` observations."""
    return gae(
        rollout.rewards, rollout.discounts(config.gamma), values[:-1].detach(),
        values[-1].detach(), config.gae_lambda, scan_impl=config.scan_impl,
        fused=config.fused_scan,
    )


def algo_loss(config, model, rollout: Rollout, dist,
              entropy_coef: float | None = None) -> tuple[torch.Tensor, dict]:
    """The loss of ``model`` on one fragment, in one pass: ``(loss,
    metrics)``. PPO here is the single-pass form (one epoch, one
    minibatch); ``Learner.update`` takes ``_ppo_multipass`` otherwise.
    ``entropy_coef`` overrides ``config.entropy_coef`` (the annealed value
    of ``entropy_coef_at``)."""
    if entropy_coef is None:
        entropy_coef = config.entropy_coef
    logits, values = _forward_fragment(model, rollout)
    if config.algo == "ppo":
        adv = _gae(config, rollout, values)
        return ppo_loss(
            logits[:-1], values[:-1], rollout.actions, rollout.behaviour_logp,
            adv.advantages, adv.returns, dist, clip_eps=config.ppo_clip_eps,
            value_coef=config.value_coef, entropy_coef=entropy_coef,
            diagnostics=config.introspect,
        )
    if config.algo == "a3c":
        return a3c_loss(
            logits[:-1], values[:-1], rollout.actions, rollout.rewards,
            rollout.discounts(config.gamma), values[-1].detach(),
            value_coef=config.value_coef, entropy_coef=entropy_coef, dist=dist,
            scan_impl=config.scan_impl, fused_scan=config.fused_scan,
            diagnostics=config.introspect,
        )
    return impala_loss(
        logits[:-1], values[:-1], rollout.actions, rollout.behaviour_logp,
        rollout.rewards, rollout.discounts(config.gamma), values[-1].detach(),
        value_coef=config.value_coef, entropy_coef=entropy_coef,
        rho_clip=config.vtrace_rho_clip, c_clip=config.vtrace_c_clip,
        dist=dist, fused_scan=config.fused_scan, diagnostics=config.introspect,
        scan_impl=config.scan_impl,
    )


def shard_rollout(rollout: Rollout, rank: int, ranks: int) -> Rollout:
    """Rank ``rank``'s env columns ``[rank*B/ranks, (rank+1)*B/ranks)`` of a
    fragment, as contiguous copies (the JAX ``P(None, "dp")`` shard)."""
    B = rollout.actions.shape[1]
    lo, hi = rank * B // ranks, (rank + 1) * B // ranks
    parts = {
        f.name: getattr(rollout, f.name)[:, lo:hi] for f in dataclasses.fields(Rollout)
    }
    parts["bootstrap_obs"] = rollout.bootstrap_obs[lo:hi]
    return Rollout(**{k: v.contiguous() for k, v in parts.items()})


def mesh_loss_and_grads(config, model, rollout: Rollout, dist, ranks: int,
                        entropy_coef: float | None = None):
    """Each rank's loss on its shard of ``rollout`` and the gradient of that
    loss scaled by ``1/ranks`` (JAX ``make_train_step``'s ``scaled_loss``):
    ``(per_rank_grads, losses, metrics)``, with one entry per rank and the
    losses unscaled. The ranks run one after the other, so one rank's
    activations are alive at a time."""
    params = list(model.parameters())
    grads, losses, metrics = [], [], []
    for rank in range(ranks):
        loss, m = algo_loss(config, model, shard_rollout(rollout, rank, ranks), dist,
                            entropy_coef)
        grads.append(list(torch.autograd.grad(loss / ranks, params)))
        losses.append(loss.detach())
        metrics.append(m)
    return grads, losses, metrics


def ppo_multipass(config) -> bool:
    """Whether PPO takes the multi-epoch minibatched update."""
    return config.algo == "ppo" and (config.ppo_epochs > 1 or config.ppo_minibatches > 1)


def validate_ppo_geometry(config, local_envs: int, label: str, unroll: int | None = None) -> None:
    """A multipass-PPO fragment of ``local_envs x unroll`` flat samples
    (``unroll`` defaults to ``config.unroll_len``) must split evenly into
    ``ppo_minibatches``."""
    if ppo_multipass(config):
        frag = local_envs * (config.unroll_len if unroll is None else unroll)
        if frag % config.ppo_minibatches:
            raise ValueError(
                f"{label} fragment of {frag} samples not divisible by "
                f"ppo_minibatches={config.ppo_minibatches}"
            )


def draw_permutations(n: int, epochs: int, generator: torch.Generator) -> list[torch.Tensor]:
    """One shuffle of the ``n`` flat samples per epoch, drawn on the
    generator's device."""
    return [torch.randperm(n, generator=generator, device=generator.device) for _ in range(epochs)]


def _ppo_multipass(config, model, optimizer: ClipAdam, opt_state: AdamState, dist,
                   rollout: Rollout, perms, entropy_coef: float | None = None,
                   ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """PPO's update: GAE once under the pre-update weights, then for each
    epoch's permutation of the flat ``T*B`` samples (``perms``, one per
    epoch), ``ppo_minibatches`` clip + Adam steps on consecutive slices of
    it, all at the update's ``entropy_coef``. Updates ``model`` and
    ``opt_state`` in place and returns the means over all steps of the
    loss, the gradient norm and the loss metrics."""
    if entropy_coef is None:
        entropy_coef = config.entropy_coef
    with torch.no_grad():
        _, values = _forward_fragment(model, rollout)
    adv = _gae(config, rollout, values)
    T, B = rollout.actions.shape[:2]
    validate_ppo_geometry(config, B, "multipass", unroll=T)
    n = T * B
    size = n // config.ppo_minibatches
    flat = {
        "obs": rollout.obs.reshape(n, *rollout.obs.shape[2:]),
        "actions": rollout.actions.reshape(n, *rollout.actions.shape[2:]),
        "behaviour_logp": rollout.behaviour_logp.reshape(n),
        "advantages": adv.advantages.reshape(n),
        "returns": adv.returns.reshape(n),
    }
    params = list(model.parameters())
    steps: list[dict[str, torch.Tensor]] = []
    for perm in perms:
        for m in range(config.ppo_minibatches):
            idx = perm[m * size:(m + 1) * size]
            batch = {k: v[idx] for k, v in flat.items()}
            dist_params, values = model(batch["obs"])
            loss, metrics = ppo_loss(
                dist_params, values, batch["actions"], batch["behaviour_logp"],
                batch["advantages"], batch["returns"], dist,
                clip_eps=config.ppo_clip_eps, value_coef=config.value_coef,
                entropy_coef=entropy_coef, diagnostics=config.introspect,
            )
            grads = torch.autograd.grad(loss, params)
            grad_norm = optimizer.step(params, grads, opt_state)
            steps.append(dict(metrics, loss=loss.detach(), grad_norm=grad_norm))
    means = {k: torch.stack([s[k] for s in steps]).mean() for k in steps[0]}
    return means.pop("loss"), means.pop("grad_norm"), means


class Learner:
    """Owns the model, the optimizer and the update step, on ``mesh``
    (default: ``make_mesh(config.mesh_shape, config.mesh_axes)`` over the
    config's device once, so one rank)."""

    def __init__(self, config, env: Environment, model: torch.nn.Module, mesh=None):
        self.device = torch.device(config.device)
        if mesh is None:
            mesh = make_mesh(config.mesh_shape, config.mesh_axes, devices=[self.device])
        if canonical_device(mesh.devices[0]) != canonical_device(self.device):
            raise ValueError(f"mesh on {mesh.devices[0]} but config.device={config.device!r}")
        config = resolve_scan_impl(config, mesh)
        self.axes = dp_axes(mesh)
        self.ranks = dp_size(mesh)
        if config.num_envs % self.ranks:
            raise ValueError(
                f"num_envs={config.num_envs} not divisible by the {self.ranks} "
                "data-parallel ranks of the mesh"
            )
        if self.ranks > 1 and config.algo == "ppo":
            raise NotImplementedError(
                "PPO on a mesh of several ranks (its global advantage moments and "
                "per-minibatch gradient reductions) comes with multi-GPU (Queue A item 11)"
            )
        if config.updates_per_call < 1:
            raise ValueError(f"updates_per_call={config.updates_per_call} must be >= 1")
        validate_ppo_geometry(config, config.num_envs, "Learner")
        self.config = config
        self.env = env
        self.model = model
        self.dist = for_spec(env.spec)
        self.optimizer = make_optimizer(config)

    def init_state(self, seed: int) -> TrainState:
        """Fresh weights on the device, zero optimizer state, fresh envs."""
        cfg = self.config
        params = self.model.to(self.device)
        stale = cfg.algo == "impala" and cfg.actor_staleness > 1
        actor_params = copy.deepcopy(params) if stale else params
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(
            params=params,
            actor_params=actor_params,
            opt_state=self.optimizer.init(list(params.parameters())),
            actor=actor_init(self.env, cfg.num_envs, generator, self.device),
            update_step=0,
            generator=generator,
        )

    def update(self, state: TrainState) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """``config.updates_per_call`` updates, in place on ``state``'s
        tensors. Metrics are device tensors, 0-dim for one update a call and
        stacked ``[K]`` for K: reading them is the caller's sync point."""
        k = self.config.updates_per_call
        if k == 1:
            return self.update_once(state)
        steps = []
        for _ in range(k):
            state, metrics = self.update_once(state)
            steps.append(metrics)
        return state, {name: torch.stack([m[name] for m in steps]) for name in steps[0]}

    def update_once(self, state: TrainState) -> tuple[TrainState, dict[str, torch.Tensor]]:
        """One update, in place on ``state``'s tensors, with 0-dim metrics.
        Multipass PPO draws its epochs' shuffles from ``state.generator``
        after the rollout."""
        cfg = self.config
        entropy_coef = entropy_coef_at(cfg, state.update_step)
        actor, rollout, stats = unroll(
            state.actor_params, self.env, state.actor, cfg.unroll_len,
            state.generator, self.dist, reward_scale=cfg.reward_scale, step_cost=cfg.step_cost,
        )
        if ppo_multipass(cfg):
            perms = draw_permutations(
                rollout.behaviour_logp.numel(), cfg.ppo_epochs, state.generator
            )
            loss, grad_norm, metrics = _ppo_multipass(
                cfg, state.params, self.optimizer, state.opt_state, self.dist, rollout, perms,
                entropy_coef,
            )
        elif self.ranks == 1:
            params = list(state.params.parameters())
            loss, metrics = algo_loss(cfg, state.params, rollout, self.dist, entropy_coef)
            grads = torch.autograd.grad(loss, params)
            grad_norm = self.optimizer.step(params, grads, state.opt_state)
        else:
            params = list(state.params.parameters())
            grads, losses, rank_metrics = mesh_loss_and_grads(
                cfg, state.params, rollout, self.dist, self.ranks, entropy_coef
            )
            reduced = reduce_grads(grads, self.axes, cfg.grad_reduce)[0]
            grad_norm = self.optimizer.step(params, reduced, state.opt_state)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in rank_metrics]).mean() for k in rank_metrics[0]}

        step = state.update_step + 1
        if cfg.algo == "impala" and cfg.actor_staleness > 1 and step % cfg.actor_staleness == 0:
            with torch.no_grad():
                for a, p in zip(state.actor_params.parameters(), state.params.parameters()):
                    a.copy_(p)
        state.actor = actor
        state.update_step = step

        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        metrics["episode_return_sum"] = stats.completed_return_sum
        metrics["episode_length_sum"] = stats.completed_length_sum
        metrics["episode_count"] = stats.completed_count
        return state, metrics
