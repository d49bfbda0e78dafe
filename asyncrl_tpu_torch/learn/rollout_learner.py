"""Learner of the host path (counterpart of ``asyncrl_tpu/learn/rollout_learner.py``):
it learns from fragments the host actors produced.

The Anakin ``Learner`` (``learn/learner.py``) rolls its envs out on the
device and learns in the same update. On the ``sebulba`` and ``cpu_async``
backends the fragments come from host env pools, so this learner exposes
the other half only: ``put_rollout`` moves a host fragment to the device,
and ``update(state, rollout)`` recomputes logits and values under the
learner weights, applies the algorithm's loss (A3C's n-step returns,
IMPALA's V-trace, PPO's GAE, each through the fused V-trace tail, the
CUDA kernel B1 on the card under ``fused_scan="auto"``), clips the
gradients and steps Adam or RMSProp, with the same functions as the Anakin
learner (``algo_loss``, ``accumulate_grads``, ``_ppo_multipass``,
``make_optimizer``).

With ``normalize_returns`` the rewards are divided by the return std from
before the update; with ``normalize_obs`` every forward sees the
observation stats from before it; both stats fold the fragment in after.
``updates_per_call`` K takes K updates over a ``[K, T, B, ...]`` slab, in
order, metrics stacked ``[K]``. Multipass PPO draws its shuffles from the
state's generator (the JAX package folds the update count into a key).

The NaN guard (``rollback_bad_windows > 0``, the divergence rollback of
``runtime/durability.py``): an update whose loss or gradient norm is not
finite changes nothing, each of the K on its own. JAX selects the old state
with ``jnp.where`` on immutable arrays; here the update writes in place, so
the armed learner copies the state's tensors into kept buffers before each
update, reads the finite flag once after it, and on a skip copies them back
and puts back the update count, the optimizer's count, the normalization
stats and the generator's state (the update after a skip draws the shuffles
the skipped one drew, as JAX's, whose key is the held update count). The
metrics keep the bad loss and add ``nonfinite_skip`` (1.0 skipped, 0.0
applied). Off, the update is the program without the guard.

Q-learning (``algo="qlearn"``) bootstraps from ``LearnerState.target_params``,
its target network, refreshed every ``actor_staleness`` updates. With the
device replay ring armed (``replay_slabs > 0``, ``learn/replay.py``) every
update, fresh or replayed, runs in IMPACT mode: the target network's
log-probs floor the behaviour log-probs at ``target_logp -
log(replay_rho_clip)`` before V-trace, the ``target_kl`` metric says how far
behaviour and target are apart, and the target refreshes every
``target_update_period`` updates. The JAX package shares the target's arrays
with the online weights, since its arrays are immutable; here the optimizer
updates the weights in place, so the target is a copy of its own, refreshed
by ``copy_``. The update never writes into the fragment it is given (a
replayed ring row is read-only): the anchor and the return scaling make new
tensors. LSTM cores re-forward each fragment from its ``init_core``.

On a mesh (``parallel/mesh.py``: ranks that share one device, a list that
repeats it) the update is the JAX ``shard_map`` body's, with the ranks run
in turn and its collectives made explicit. A fragment's env columns split
over the data-parallel axes (``("dp",)`` or the hybrid ``("dcn", "dp")``),
rank r owning ``[r*B/dp, (r+1)*B/dp)``; with an ``sp`` axis each rank's
columns are cut further into ``sp`` time segments, and the ``dp * sp``
shards run in the mesh's row-major order (``reduce_axes``). On a
data-parallel mesh each rank takes its loss and gradient on its columns
(``mesh_loss_and_grads``, over its ``grad_accum`` chunks), scaled by
``1/dp``; one ``reduce_grads`` by ``config.grad_reduce`` sums them (the ring,
B4, with ``"ring"``) and one optimizer step applies the sum. On a ``(dp,
sp)`` mesh every shard forwards its own segment, V-trace, GAE or the n-step
returns come from the two-level solves of ``parallel/timeshard.py``
(``_algo_loss_timesharded``), each shard's loss is scaled by ``1/(dp * sp *
grad_accum)`` and psum sums the shards' gradients; the fused tail B1 has no
time-sharded form, so it runs on unsharded time axes only. Multipass PPO
shuffles each shard's own samples (``_ppo_multipass``), and single-pass PPO
normalises by the mean of the shards' advantage moments. Metrics, the
IMPACT ``target_kl`` included, are the means over the shards, and the
normalization stats fold every shard's block in. A mesh across processes is
refused: the JAX package launches only the Anakin learner across hosts.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch

from asyncrl_tpu_torch.config import resolve_scan_impl
from asyncrl_tpu_torch.learn.learner import (
    AdamState, RMSPropState, _ppo_multipass, accumulate_grads, draw_permutations,
    entropy_coef_at, make_optimizer, mesh_loss_and_grads, ppo_advantage_moments, ppo_multipass,
    ppo_shuffle_size, qlearn_bootstrap, shard_rollout, split_time_rollout,
    validate_grad_accum_config, validate_qlearn_config, validate_recurrent_config,
)
from asyncrl_tpu_torch.learn.replay import validate_replay_config
from asyncrl_tpu_torch.models.networks import is_recurrent
from asyncrl_tpu_torch.obs import introspect
from asyncrl_tpu_torch.obs import spans as span_names
from asyncrl_tpu_torch.obs import trace
from asyncrl_tpu_torch.ops.distributions import for_config
from asyncrl_tpu_torch.ops.losses import a3c_loss, impala_loss, ppo_loss, qlearn_loss
from asyncrl_tpu_torch.ops.normalize import (
    RunningStats, init_stats, normalizing_apply, update_stats,
)
from asyncrl_tpu_torch.parallel.mesh import (
    axis_size, canonical_device, dp_size, group_mean, group_means, make_mesh, reduce_axes,
    reduce_grads, time_shards,
)
from asyncrl_tpu_torch.parallel.timeshard import (
    gae_timesharded, n_step_returns_timesharded, vtrace_timesharded,
)
from asyncrl_tpu_torch.rollout.buffer import Rollout, rollout_map


@dataclasses.dataclass
class LearnerState:
    """The host path's train state: the learner weights, the optimizer
    state, the update count, the generator of PPO's shuffles and the
    normalization stats (None when off). ``target_params`` is Q-learning's
    target network, and the IMPACT anchor's with the replay ring (None
    otherwise): a copy of the weights, refreshed in place. Unlike the
    Anakin ``TrainState`` there is no actor state (envs live on the host)
    and no actor copy of the weights (actors act under the trainer's
    published snapshots)."""

    params: torch.nn.Module
    opt_state: AdamState | RMSPropState
    update_step: int
    generator: torch.Generator
    obs_stats: RunningStats | None = None
    ret_stats: RunningStats | None = None
    target_params: torch.nn.Module | None = None


def _algo_loss_timesharded(config, model, rollout: Rollout, segments: int, dist,
                           target=None, entropy_coef: float | None = None, moments=None
                           ) -> list[tuple[torch.Tensor, dict]]:
    """JAX ``_algo_loss_timesharded`` on one rank's fragment (or
    ``grad_accum`` chunk) with its time axis cut into ``segments``: each
    segment forwards its own observations, the bootstrap forward of
    ``bootstrap_obs`` (which JAX replicates over the time axis) serves them
    all, and the n-step returns, V-trace or GAE come from the two-level
    solves of ``parallel/timeshard.py``. Returns each segment's ``(loss,
    metrics)``, local means, in time order; a segment's loss depends on its
    own forward only. IMPALA's clip fractions are the whole fragment's
    (``vtrace_timesharded`` averages them over the segments). ``moments``:
    PPO's advantage moments over the whole mesh (JAX's ``pmean`` over the
    reduce axes)."""
    if entropy_coef is None:
        entropy_coef = config.entropy_coef
    segs = split_time_rollout(rollout, segments)
    outs = [model(seg.obs) for seg in segs]
    logits, values = [o[0] for o in outs], [o[1] for o in outs]
    with torch.no_grad():
        boot_logits, bootstrap_value = model(rollout.bootstrap_obs)
    discounts = [seg.discounts(config.gamma) for seg in segs]
    rewards = [seg.rewards for seg in segs]
    if config.algo == "qlearn":
        with torch.no_grad():
            q_target, _ = target(rollout.bootstrap_obs)
        boot = qlearn_bootstrap(config, boot_logits, q_target)
        returns = n_step_returns_timesharded(rewards, discounts, boot)
        return [qlearn_loss(q, seg.actions, seg.rewards, d, boot, returns=r,
                            huber_delta=config.huber_delta)
                for q, seg, d, r in zip(logits, segs, discounts, returns)]
    if config.algo == "a3c":
        returns = n_step_returns_timesharded(rewards, discounts, bootstrap_value)
        return [a3c_loss(lg, v, seg.actions, seg.rewards, d, bootstrap_value,
                         value_coef=config.value_coef, entropy_coef=entropy_coef, dist=dist,
                         diagnostics=config.introspect, returns=r)
                for lg, v, seg, d, r in zip(logits, values, segs, discounts, returns)]
    if config.algo == "impala":
        target_logp = [dist.logp(lg, seg.actions).detach() for lg, seg in zip(logits, segs)]
        vts = vtrace_timesharded([seg.behaviour_logp for seg in segs], target_logp, rewards,
                                 discounts, [v.detach() for v in values], bootstrap_value,
                                 rho_clip=config.vtrace_rho_clip, c_clip=config.vtrace_c_clip)
        return [impala_loss(lg, v, seg.actions, seg.behaviour_logp, seg.rewards, d,
                            bootstrap_value, value_coef=config.value_coef,
                            entropy_coef=entropy_coef, rho_clip=config.vtrace_rho_clip,
                            c_clip=config.vtrace_c_clip, dist=dist,
                            diagnostics=config.introspect, vtrace_out=vt)
                for lg, v, seg, d, vt in zip(logits, values, segs, discounts, vts)]
    if config.algo == "ppo":
        advs = gae_timesharded(rewards, discounts, [v.detach() for v in values],
                               bootstrap_value, config.gae_lambda)
        return [ppo_loss(lg, v, seg.actions, seg.behaviour_logp, adv.advantages, adv.returns,
                         dist, clip_eps=config.ppo_clip_eps, value_coef=config.value_coef,
                         entropy_coef=entropy_coef, diagnostics=config.introspect,
                         moments=moments)
                for lg, v, seg, adv in zip(logits, values, segs, advs)]
    raise ValueError(f"unknown algo {config.algo!r} for time sharding")


def timesharded_loss_and_grads(config, model, rollout: Rollout, dist, ranks: int,
                               segments: int, entropy_coef: float | None = None, target=None,
                               moments=None):
    """Each ``(rank, segment)`` shard's loss and its gradient on a ``(dp,
    sp)`` mesh, in the shards' row-major order: rank r's columns (over
    ``grad_accum`` chunks of them, the chunks' gradients summed in order
    and their losses and metrics averaged, JAX ``accumulate_grads``), each
    cut into ``segments`` (:func:`_algo_loss_timesharded`), each segment's
    loss scaled by ``1 / (ranks * segments * grad_accum)``. Returns
    ``(per_shard_grads, losses, metrics)``, the losses unscaled. One rank's
    chunk's activations are alive at a time."""
    n = max(config.grad_accum, 1)
    scale = ranks * segments * n
    params = list(model.parameters())
    grads, losses, metrics = [], [], []
    for rank in range(ranks):
        shard = rollout if ranks == 1 else shard_rollout(rollout, rank, ranks)
        chunks = [shard] if n == 1 else [shard_rollout(shard, i, n) for i in range(n)]
        seg_grads, seg_losses, seg_metrics = [None] * segments, [], []
        for chunk in chunks:
            out = _algo_loss_timesharded(config, model, chunk, segments, dist, target,
                                         entropy_coef, moments)
            for s, (loss, _) in enumerate(out):
                g = torch.autograd.grad(loss / scale, params)
                seg_grads[s] = list(g) if seg_grads[s] is None else [
                    a + b for a, b in zip(seg_grads[s], g)]
            seg_losses.append([loss.detach() for loss, _ in out])
            seg_metrics.append([m for _, m in out])
        for s in range(segments):
            grads.append(seg_grads[s])
            losses.append(torch.stack([c[s] for c in seg_losses]).mean())
            metrics.append({k: torch.stack([c[s][k] for c in seg_metrics]).mean()
                            for k in seg_metrics[0][s]})
    return grads, losses, metrics


class RolloutLearner:
    """``update(state, rollout)`` and the state's lifecycle, on ``mesh``
    (default: one rank of ``config.device``)."""

    def __init__(self, config, spec, model: torch.nn.Module, mesh=None):
        self.device = torch.device(config.device)
        if mesh is None:
            mesh = make_mesh(config.mesh_shape, config.mesh_axes, devices=[self.device])
        if canonical_device(mesh.devices[0]) != canonical_device(self.device):
            raise ValueError(f"mesh on {mesh.devices[0]} but config.device={config.device!r}")
        if mesh.processes > 1:
            raise NotImplementedError(
                f"the host learner on a mesh across {mesh.processes} processes: the JAX "
                "package's multi-host launch is Anakin-only (asyncrl_tpu/cli/launch.py takes "
                "backend='tpu' only), so the host path runs its mesh in one process"
            )
        validate_recurrent_config(config, model)
        validate_qlearn_config(config)
        validate_replay_config(config)
        # The per-rank env count the chunker sees is num_envs over the
        # data-parallel ranks, as in JAX (not the per-actor fragment's).
        validate_grad_accum_config(config, config.num_envs // dp_size(mesh))
        if config.selfplay:
            raise NotImplementedError(
                "selfplay is Anakin-only (backend='tpu'): host actor threads have no "
                "opponent-snapshot channel"
            )
        sp = time_shards(mesh)
        if sp > 1:
            if config.unroll_len % sp:
                raise ValueError(f"unroll_len={config.unroll_len} not divisible by the "
                                 f"time-shard axis sp={sp}")
            if is_recurrent(model):
                raise NotImplementedError(
                    "recurrent cores cannot be time-sharded: an LSTM carry composes "
                    "nonlinearly, so unlike the affine V-trace/GAE recurrences it has no exact "
                    "parallel decomposition — a time-sharded LSTM degenerates to a pipeline "
                    "that re-serializes the sp axis (full rationale: docs/ARCHITECTURE.md, "
                    "'Recurrent cores are deliberately NOT time-shardable'). Use a dp-only "
                    "mesh for core='lstm'"
                )
        if config.updates_per_call < 1:
            raise ValueError(f"updates_per_call={config.updates_per_call} must be >= 1")
        config = resolve_scan_impl(config, mesh)
        self.reduce_axes = reduce_axes(mesh)
        if config.grad_reduce == "ring" and len(self.reduce_axes) != 1:
            raise ValueError(
                f"ring gradient reduction needs a single mesh axis, got {self.reduce_axes}; "
                "use grad_reduce='psum' on a time-sharded mesh"
            )
        self.mesh = mesh
        self.ranks = dp_size(mesh)
        self.time_shards = sp
        self.shards = axis_size(mesh, self.reduce_axes)
        self.config = config
        self.spec = spec
        self.model = model
        self.optimizer = make_optimizer(config)
        self.dist = for_config(config, spec)
        # IMPACT mode (learn/replay.py): with the ring armed every update
        # runs under the target network's anchor.
        self.replay_mode = config.replay_slabs > 0
        # The NaN guard's kept copy of the state's tensors (allocated at the
        # first armed update).
        self.nan_guard = config.rollback_bad_windows > 0
        self._held: list[torch.Tensor] | None = None
        # First-call-per-shape accounting (obs/introspect.py): the update
        # sees one fragment geometry in a run, so any further count is a
        # geometry change the throughput numbers would otherwise hide. Only
        # the rollout (and PPO's shuffles) are signature-walked. Reads the
        # RESOLVED flag (the trainers fold ASYNCRL_INTROSPECT in).
        self._step = self._update
        if config.introspect:
            self._step = introspect.instrument(
                self._update, "learner.update",
                counters=("compiles", "learner_recompile"),
                ignore_argnums=(0,),
            )

    # ---------------------------------------------------------------- state

    def init_state(self, seed: int) -> LearnerState:
        """The model's weights on the device, a zero optimizer state, the
        stats before any data."""
        params = self.model.to(self.device)
        cfg = self.config
        target = None
        if cfg.algo == "qlearn" or self.replay_mode:
            # The target starts equal to the weights, as a copy of its own:
            # the optimizer updates the weights in place.
            with torch.no_grad():
                target = copy.deepcopy(params).requires_grad_(False)
        return LearnerState(
            params=params,
            opt_state=self.optimizer.init(list(params.parameters())),
            update_step=0,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            obs_stats=(init_stats(self.spec.obs_shape, self.device)
                       if cfg.normalize_obs else None),
            ret_stats=init_stats((), self.device) if cfg.normalize_returns else None,
            target_params=target,
        )

    # --------------------------------------------------------------- update

    def put_rollout(self, rollout: Rollout, out: Rollout | None = None) -> Rollout:
        """A host fragment (tensors or numpy arrays, ``[T, B, ...]`` or a
        ``[K, T, B, ...]`` slab) on the learner's device: copied into
        ``out`` (device tensors of its shapes) or into fresh tensors, with
        ``non_blocking`` (asynchronous from pinned memory). On the CPU, with
        no ``out``, the host tensors themselves.

        The span is the issue cost only (the copies are asynchronous from
        pinned memory); the unhidden transfer time shows up in the
        trainer's ``learner.h2d_wait`` span around its barrier."""
        with trace.span(span_names.LEARNER_H2D):
            if out is None:
                return rollout_map(
                    lambda x: torch.as_tensor(x).to(self.device, non_blocking=True), rollout
                )
            for f in dataclasses.fields(Rollout):
                src, dst = getattr(rollout, f.name), getattr(out, f.name)
                if src is None:
                    continue
                pairs = zip(dst, src) if f.name == "init_core" else ((dst, src),)
                for d, s in pairs:
                    d.copy_(torch.as_tensor(s), non_blocking=True)
            return out

    def _shard_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the shards of each shard's mean of a time-major
        ``[T, B]`` tensor (JAX's ``pmean`` of a local mean); one shard's
        mean on one rank."""
        if self.shards == 1:
            return torch.mean(x)
        return group_mean([seg.mean() for cols in x.chunk(self.ranks, dim=1)
                           for seg in cols.chunk(self.time_shards, dim=0)])

    def update(self, state: LearnerState, rollout: Rollout, perms=None):
        """``updates_per_call`` updates on a device-resident fragment (a
        ``[K, T, B, ...]`` slab for K > 1), in place on ``state``'s tensors.
        Metrics are device tensors, 0-dim for one update a call and ``[K]``
        for K. ``perms``: each update's list of PPO epoch shuffles, one
        ``[shards, n]`` tensor an epoch whose row i permutes shard i's ``n``
        local samples (drawn from ``state.generator`` when None). The span
        covers the launches (on the CPU, the compute itself)."""
        with trace.span(span_names.LEARNER_UPDATE):
            if perms is None:
                return self._step(state, rollout)
            return self._step(state, rollout, perms)

    def _update(self, state: LearnerState, rollout: Rollout, perms=None):
        K = self.config.updates_per_call
        once = self._guarded_once if self.nan_guard else self._update_once
        if K == 1:
            return once(state, rollout, None if perms is None else perms[0])
        steps = []
        for k in range(K):
            state, metrics = once(
                state, rollout_map(lambda x, k=k: x[k], rollout),
                None if perms is None else perms[k],
            )
            steps.append(metrics)
        return state, {name: torch.stack([m[name] for m in steps]) for name in steps[0]}

    @staticmethod
    def _state_tensors(state: LearnerState) -> list[torch.Tensor]:
        """The tensors an update writes in place: the weights, the
        optimizer's moments and the target network's weights."""
        opt = state.opt_state
        tensors = list(state.params.parameters()) + list(opt.nu)
        if isinstance(opt, AdamState):
            tensors += opt.mu
        if state.target_params is not None:
            tensors += list(state.target_params.parameters())
        return tensors

    def _guarded_once(self, state: LearnerState, rollout: Rollout, perms):
        """One update under the NaN guard: applied if its loss and gradient
        norm are finite, else the state as it was, bit for bit. One host
        read, of the finite flag."""
        tensors = self._state_tensors(state)
        if self._held is None:
            self._held = [torch.empty_like(t) for t in tensors]
        with torch.no_grad():
            torch._foreach_copy_(self._held, tensors)
        kept = (state.update_step, state.opt_state.count, state.obs_stats, state.ret_stats,
                state.generator.get_state())
        state, metrics = self._update_once(state, rollout, perms)
        finite = torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])
        metrics["nonfinite_skip"] = (~finite).to(torch.float32)
        if not finite.item():
            with torch.no_grad():
                torch._foreach_copy_(tensors, self._held)
            (state.update_step, state.opt_state.count, state.obs_stats, state.ret_stats,
             generator_state) = kept
            state.generator.set_state(generator_state)
        return state, metrics

    def _update_once(self, state: LearnerState, rollout: Rollout, perms):
        cfg = self.config
        if state.ret_stats is not None:
            # The mean is not subtracted: shifting rewards changes the MDP.
            ret_var = state.ret_stats.m2 / state.ret_stats.count
            rollout = dataclasses.replace(
                rollout, rewards=rollout.rewards * torch.rsqrt(torch.clamp(ret_var, min=1e-8))
            )
        model = normalizing_apply(state.params, state.obs_stats)
        target = None
        if state.target_params is not None:
            target = normalizing_apply(state.target_params, state.obs_stats)
        target_kl = None
        if self.replay_mode:
            # The IMPACT anchor: the target network's log-probs floor the
            # behaviour log-probs, so the V-trace ratio pi/mu never exceeds
            # replay_rho_clip * pi/pi_target, however long ago a replayed
            # slab's mu acted. A new tensor: the row stays as published.
            with torch.no_grad():
                t_logits, _ = target(rollout.obs)
                target_logp = self.dist.logp(t_logits, rollout.actions)
            target_kl = self._shard_mean(rollout.behaviour_logp - target_logp)
            rollout = dataclasses.replace(rollout, behaviour_logp=torch.maximum(
                rollout.behaviour_logp, target_logp - math.log(cfg.replay_rho_clip)))
        entropy_coef = entropy_coef_at(cfg, state.update_step)
        params = list(state.params.parameters())
        q_target = target if cfg.algo == "qlearn" else None
        if ppo_multipass(cfg):
            if perms is None:
                perms = draw_permutations(ppo_shuffle_size(rollout, self.shards), cfg.ppo_epochs,
                                          state.generator, self.shards)
            loss, grad_norm, metrics = _ppo_multipass(
                cfg, model, self.optimizer, state.opt_state, self.dist, rollout, perms,
                entropy_coef, self.ranks, self.reduce_axes, time_shards=self.time_shards,
            )
        elif self.shards == 1:
            grads, loss, metrics = accumulate_grads(cfg, model, rollout, self.dist, 1,
                                                    entropy_coef, q_target)
            grad_norm = self.optimizer.step(params, grads, state.opt_state)
        else:
            if self.time_shards == 1:
                grads, losses, shard_metrics = mesh_loss_and_grads(
                    cfg, model, rollout, self.dist, self.ranks, entropy_coef, q_target)
            else:
                moments = (ppo_advantage_moments(cfg, model, rollout, self.ranks,
                                                 self.time_shards)
                           if cfg.algo == "ppo" else None)
                grads, losses, shard_metrics = timesharded_loss_and_grads(
                    cfg, model, rollout, self.dist, self.ranks, self.time_shards, entropy_coef,
                    q_target, moments)
            reduced = reduce_grads(grads, self.reduce_axes, cfg.grad_reduce)[0]
            grad_norm = self.optimizer.step(params, reduced, state.opt_state)
            metrics = group_means([dict(m, loss=loss) for loss, m in zip(losses, shard_metrics)])
            loss = metrics.pop("loss")
        step = state.update_step + 1
        # Q-learning's target refreshes every actor_staleness updates, the
        # IMPACT anchor every target_update_period.
        period = cfg.actor_staleness if cfg.algo == "qlearn" else cfg.target_update_period
        if state.target_params is not None and step % period == 0:
            with torch.no_grad():
                for t, p in zip(state.target_params.parameters(), state.params.parameters()):
                    t.copy_(p)
        # The stats fold this fragment in for the next update.
        if state.obs_stats is not None:
            state.obs_stats = update_stats(state.obs_stats, rollout.obs, self.ranks,
                                           time_shards=self.time_shards)
        if state.ret_stats is not None:
            state.ret_stats = update_stats(state.ret_stats, rollout.disc_returns, self.ranks,
                                           time_shards=self.time_shards)
        state.update_step = step
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = grad_norm
        if target_kl is not None:
            metrics["target_kl"] = target_kl
        return state, metrics
