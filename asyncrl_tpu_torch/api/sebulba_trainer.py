"""SebulbaTrainer: host actor threads and a learner on the device, pipelined
(counterpart of ``asyncrl_tpu/api/sebulba_trainer.py``, its core).

``backend="sebulba"`` is the answer for envs that cannot live in device
memory (the C++ env pool, gymnasium suites): actor threads step host env
pools and write fragments into pinned staging slabs
(``rollout/staging.py``); the drain copies each full slab into a device
slot (``rollout/device_queue.py``) while the previous update still runs,
and the ``RolloutLearner`` updates on it; the trainer publishes a snapshot
of the weights to the actors every ``actor_staleness`` updates. The
bounded queue is the pipelining element: actors run ahead of the learner
by up to ``queue_capacity`` fragments, which V-trace (``algo="impala"``)
corrects for.

Each window's metrics are ``Trainer.train``'s (``env_steps``, ``fps``, the
episode stats, the loss terms) and the pipeline's: ``param_lag`` (learner
updates between a fragment's policy and the update that consumed it),
``learner_stall_frac`` (the share of the window the drain waited for
fragments), ``h2d_wait_s`` (copy time the previous update did not hide),
``h2d_bytes``, ``queue_backpressure`` (actor puts that found the queue
full), ``slab_reuse_waits``, ``devq_reuse_waits`` and ``actor_restarts``.

Q-learning actors act epsilon-greedily on the schedule of
``_epsilon_fn``; LSTM actors keep their carry on the device and the learner
re-forwards each fragment from its ``init_core``. With
``inference_server=True`` the actors share one server: the serving tier's
``ServeCore`` (``serve/scheduler.py``) under ``serve=True``, the coalescing
``InferenceServer`` (``rollout/inference_server.py``) under
``serve=False``. Either makes one batched forward a round instead of one a
thread, the window key ``infer_coalesce_batch`` the mean rows a round; the
serve core adds ``serve_dispatch_full``/``serve_dispatch_deadline`` and
``serve_latency_ms_*``. With ``gateway_port != 0`` the external gateway
(``serve/gateway.py``) answers ``/v1/act`` and ``/v1/evaluate`` over HTTP
through the serve core while training runs; its window keys are
``gateway_requests``, ``gateway_<tenant>_latency_ms_*``, ``gateway_live``
and ``gateway_restarts``. Every window also carries ``servers_live`` and
the serving tier's registry (``obs/registry.py``), and ``fault_<site>``
when ``fault_spec`` arms a site. ``ASYNCRL_SERVE`` and ``ASYNCRL_REPLAY``,
when set, win over ``serve`` and ``replay_slabs``; both are read once,
here. With ``replay_slabs > 0`` the
device replay ring (``learn/replay.py``) keeps the last fragments on the
device: each fresh slab is copied into it before its update, and
``replay_passes - 1`` replayed rows follow, publishing on the same cadence
(window keys ``replay_fill_frac``, ``reuse_p50/p95/max``,
``target_lag_mean``, ``learner_stall_trend`` and the learner's
``target_kl``).

With ``mesh=`` (``parallel/mesh.py``, ranks that share the card) the
``RolloutLearner`` shards each fragment over the mesh's data-parallel ranks
and, with an ``sp`` axis, its time segments; the actors, the staging slabs,
the device queue's slots and the replay ring hold whole fragments, the same
on any mesh. The default mesh is one rank of ``config.device``.

Supervision (``_supervise``, once a drain iteration, in this order): a dead
or hung server is rebuilt, and its clients' actors restart on the new one;
an ``InvariantViolation`` aborts. A dead gateway is rebuilt on the same port
without touching the actors. With ``stall_timeout_s > 0`` the heartbeat
watchdog retires an actor whose progress stamp is older than that (its
``abandon`` event) and restarts it; a server's outage is not charged to
the actors blocked on it. A dead actor is restarted with a fresh pool.
Restarts that come too fast abort the run: more than 3 an actor within
``_RESTART_WINDOW_S``, counted apart for crashes and for the watchdog.
Evaluation pools step outside the supervised pipeline, with their
``pool.step`` site disarmed. Checkpoints hold the learner state, and every
save's metadata the run state (``run_state``: the fleet size, the update
count, the actor seed cursor, the health monitor's window cursor and the
restart counters); host envs restart fresh on resume, as after an actor
restart; the checkpoint writer runs off the train thread
(``utils/checkpoint.py``).

With ``drain_grace_s > 0`` (the default 30; ``ASYNCRL_DRAIN_GRACE_S`` wins
when set) ``train`` drains on SIGTERM or SIGINT (``runtime/durability.py``):
the gateway refuses new requests from the signal on, admissions close, the
actors stop, the partial window reaches the callback with
``drain_preempt: 1.0``, one final checkpoint is written and
``PreemptedExit`` (exit code 86) leaves ``train``; the fault spec's
``actor.queue_put:preempt`` scripts the signal. ``ASYNCRL_INTROSPECT`` wins
over ``introspect``.

The crash-consistent resume (``resume=True``, or ``ASYNCRL_RESUME`` when
set): ``checkpoint_dir``'s auto-resume restores the learner state, and the
restored step's ``run_state`` the rest of the run at construction: the
update count, the staleness ledger rebased on it, the actor seed cursor,
the restart counters, the health monitor's window cursor and, with the
elastic runtime on, the fleet size, which ``train`` rebuilds one slot at a
time through the elastic executors right after the actors start (the
flight recorder's ``durability.fleet_restored``). The time-series store
goes on as a new segment opened by a ``resume`` event. Resume off, or a
checkpoint without ``run_state``, restores the learner state alone.

The elastic runtime (``runtime/elastic.py``; ``elastic=True``, or
``ASYNCRL_ELASTIC`` when set): at each window close an
``ElasticController`` reads the window and may move the actor fleet one
slot within ``[elastic_min_actors, elastic_max_actors]``; the fault spec's
``scale`` kind scripts such moves. A move runs behind a
``ReconfigureBarrier`` (a checkpoint saved and waited for before it,
restored if it fails), inside the ``elastic.reconfigure`` span: a new slot
registers its serve-core client before its actor spawns, a retired slot
goes through the watchdog's retirement path (its ``abandon`` event, the
join, the lease void) without entering a storm window, and the staging
ring, behind a ``RingSwapHolder``, is swapped for one sized to the new
fleet while the old ring's leases finish there. Each move counts
``elastic_scale_up``/``elastic_scale_down`` and annotates the time-series
store; a failed one counts ``elastic_reconfigure_failed``; all three dump
the flight recorder. Elastic off constructs nothing elastic.

Tracing and forensics (``obs/``, set up once at construction by
``obs.setup``): with ``trace=True`` (``ASYNCRL_TRACE`` wins when set) the
actors, the shared server, the staging ring, the learner and this drain
record spans into per-thread rings; each window carries ``trace_spans``,
``trace_dropped_spans`` and the flight recorder's counters; every fault
fire and every supervisor event below (``supervisor.actor_restart``,
``server_restart``, ``gateway_restart``, ``gateway_rebind_failed``,
``invariant_abort``, ``storm_abort``, ``preempt``) dumps
``flightrec-*.json`` into the run directory (``ASYNCRL_RUN_DIR``, else
``run_dir``, else ``runs/<env>-<algo>-s<seed>-<stamp>-<pid>``); ``close``
writes the rings as ``trace-*.json``. Every window, traced or not, carries
the ``h2d_wait_ms`` histogram.

Run health (``obs/``): with tracing on or ``obs_http_port`` set
(``ASYNCRL_OBS_PORT`` wins) every window runs the detectors
(``health_events``, ``health_status``, ``health_<detector>`` counters and a
``health.<detector>`` dump each), lands in the time-series store
(``<run_dir>/timeseries.jsonl``) and is served on ``/metrics``,
``/healthz`` and ``/timeseries``. With ``introspect`` on the windows also
carry ``staleness_p50/p95/max/mean`` (the per-fragment lags behind
``param_lag``), the first-call-per-shape counters of the inference and
learner entry points (``compiles``, ``infer_recompile``,
``learner_recompile``, ``compile_ms_*``) and the memory watermarks
(``mem_*``).

The divergence rollback (``rollback_bad_windows > 0``, which needs
``checkpoint_dir``): the learner's NaN guard skips every update whose loss
or gradient norm is not finite (the windows carry the cumulative
``nonfinite_skips``), and at each window close, before the elastic
controller, a ``RollbackPolicy`` (``runtime/durability.py``) judges the
window by the health events fired in it (without a monitor, by a non-finite
``loss`` or ``grad_norm`` in the window). A bad window quarantines the
fragments in flight (their staging leases voided, the replay ring emptied;
``rollback_quarantined``, ``replay_quarantined``); the policy's
``rollback_bad_windows``-th bad window in a row restores the newest
retained step no later than the last good one (the oldest retained step if
that one is gone; the newer steps deleted), folds the actor seed cursor and
republishes at once; past ``rollback_max_attempts`` restores the run stops
and raises. Each action counts ``rollback_quarantine``,
``rollback_restores`` or ``rollback_abort``, dumps ``rollback.<kind>`` and
annotates the time-series store; a window in which one fired skips the
elastic controller. ``run_state`` carries the policy's ``attempts``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import queue
import sys
import threading
import time
import types
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from asyncrl_tpu_torch import obs
from asyncrl_tpu_torch.config import Config, default_eval_max_steps
from asyncrl_tpu_torch.learn import replay as replay_lib
from asyncrl_tpu_torch.learn.learner import (
    qlearn_epsilon_at_frames, validate_ppo_geometry, validate_train_target,
)
from asyncrl_tpu_torch.learn.rollout_learner import LearnerState, RolloutLearner
from asyncrl_tpu_torch.models.networks import build_model, is_recurrent, reset_core
from asyncrl_tpu_torch.obs import flightrec, introspect
from asyncrl_tpu_torch.obs import registry as obs_registry
from asyncrl_tpu_torch.obs import spans as span_names
from asyncrl_tpu_torch.obs import trace
from asyncrl_tpu_torch.ops.distributions import for_config
from asyncrl_tpu_torch.ops.normalize import normalizing_apply
from asyncrl_tpu_torch.parallel.mesh import TIME_AXIS, dp_size, make_mesh
from asyncrl_tpu_torch.rollout.buffer import rollout_leaves
from asyncrl_tpu_torch.rollout.sebulba import (
    ActorThread, Fragment, FragmentSequenceChecker, ParamStore, inference_mode, make_host_pool,
    make_inference_fn, snapshot_policy,
)
from asyncrl_tpu_torch.runtime import durability
from asyncrl_tpu_torch.utils import checkpoint, faults
from asyncrl_tpu_torch.utils.debug import sync_debug_enabled
from asyncrl_tpu_torch.utils.device import resolve_device


def _stack_fragments(rollouts):
    """K host fragments -> one ``[K, T, B, ...]`` stack (the copy path,
    ``overlap_h2d=False``); one fragment passes through as it is."""
    if len(rollouts) == 1:
        return rollouts[0]

    def stack(name):
        first = getattr(rollouts[0], name)
        if first is None:
            return None
        if name == "init_core":
            return tuple(np.stack([r.init_core[i] for r in rollouts]) for i in range(len(first)))
        return np.stack([getattr(r, name) for r in rollouts])

    return type(rollouts[0])(**{f.name: stack(f.name) for f in dataclasses.fields(rollouts[0])})


def _record_event(device: torch.device):
    """An event recorded on ``device``'s current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class SebulbaTrainer:
    """Owns the host actor threads, the param store and the learner.
    ``spec`` and ``model`` default to the host pool's spec and a model from
    ``config.seed``; ``mesh`` to one rank on ``config.device``."""

    # Restarts beyond 3 an actor within this window abort the run (crashes
    # and watchdog retirements each in a window of their own).
    _RESTART_WINDOW_S = 300.0

    def __init__(self, config: Config, spec=None, model=None, mesh=None, restore=None):
        # The chaos layer (utils/faults.py), armed from config.fault_spec
        # unless ASYNCRL_FAULTS is set (the environment wins); an empty spec
        # disarms, so a fresh trainer never inherits another's sites. Armed
        # before the body, and disarmed again if construction fails.
        armed = not os.environ.get(faults.ENV_VAR)
        if armed:
            faults.arm(config.fault_spec)
        try:
            self._init(config, spec, model, mesh, restore)
        except BaseException:
            if armed:
                faults.disarm()
            raise

    def _init(self, config, spec, model, mesh, restore):
        self.device = resolve_device(config.device)
        # ASYNCRL_REPLAY wins over config.replay_slabs when set, read once
        # here, so the learner and the ring read the same depth.
        env_replay = os.environ.get("ASYNCRL_REPLAY", "")
        if env_replay and int(env_replay) != config.replay_slabs:
            config = config.replace(replay_slabs=int(env_replay))
        # ASYNCRL_INTROSPECT wins over config.introspect when set, read once
        # here: the learner's loss reads the resolved flag.
        config = introspect.resolve(config)
        self.config = config
        # The runtime's environment overrides, read once where the JAX
        # trainer reads them: the drain's grace and the resume flag
        # (ASYNCRL_DRAIN_GRACE_S and ASYNCRL_RESUME win when set;
        # ASYNCRL_RUN_DIR by obs.setup below; ASYNCRL_ELASTIC just below).
        self._drain_grace = durability.drain_grace(config)
        self._resume_on = durability.resume_enabled(config)
        registry = faults.active()
        if registry is not None and registry.has_kind("preempt") and self._drain_grace <= 0:
            raise ValueError(
                "fault spec arms a 'preempt' site but the preemption drain is disabled "
                "(drain_grace_s=0 / ASYNCRL_DRAIN_GRACE_S=0): the scripted SIGTERM would kill "
                "the run undrained instead of testing the drain"
            )
        # The divergence rollback: armed by rollback_bad_windows > 0, which
        # also arms the learner's NaN guard. Nothing to roll back to without
        # retained checkpoints.
        self._rollback = None
        if config.rollback_bad_windows > 0:
            if not config.checkpoint_dir:
                raise ValueError(
                    "rollback_bad_windows > 0 requires checkpoint_dir: divergence rollback "
                    "restores the last-good retained checkpoint"
                )
            self._rollback = durability.RollbackPolicy(config.rollback_bad_windows,
                                                       config.rollback_max_attempts)
        # The NaN guard's skipped updates over the run (window key
        # nonfinite_skips).
        self._nonfinite_skips = 0.0
        # ASYNCRL_SERVE wins over config.serve when set, read once here.
        self._serve_core = _use_serve_core(config)
        # The elastic runtime (runtime/elastic.py): ASYNCRL_ELASTIC wins over
        # config.elastic when set, read once here, and the compositions it
        # cannot run are refused before anything is built.
        self._elastic_on = _use_elastic(config)
        if self._elastic_on:
            if config.updates_per_call > 1:
                raise ValueError(
                    "elastic=True requires updates_per_call=1: a fused "
                    "[K>1] slab interrupted by a ring swap would strand "
                    "its partial batch"
                )
            if config.inference_server and not self._serve_core:
                raise ValueError(
                    "elastic=True requires the serve core for the shared "
                    "server (serve=True / ASYNCRL_SERVE=1): the legacy "
                    "InferenceServer's client set is fixed-shape"
                )
            emin, emax = self._elastic_bounds()
            if not emin <= config.actor_threads <= emax:
                raise ValueError(
                    f"actor_threads={config.actor_threads} outside the "
                    f"elastic bounds [{emin}, {emax}]"
                )
        elif registry is not None and registry.has_kind("scale"):
            raise ValueError(
                "fault spec arms a 'scale' site but the elastic "
                "runtime is off (elastic=True / ASYNCRL_ELASTIC=1): "
                "scripted scale requests would accumulate with no "
                "controller to drain them"
            )
        if config.num_envs % config.actor_threads:
            raise ValueError(f"num_envs={config.num_envs} not divisible by "
                             f"actor_threads={config.actor_threads}")
        self._envs_per_actor = config.num_envs // config.actor_threads

        # The spec comes from a probe pool: the host envs are authoritative.
        probe = make_host_pool(config, 1, seed=config.seed)
        self.spec = spec if spec is not None else probe.spec
        _close(probe)
        if model is None:
            model = build_model(config, self.spec, torch.Generator().manual_seed(config.seed))
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh_shape, config.mesh_axes, devices=[self.device])

        # The geometry checks of the JAX trainer, before any thread starts.
        dp = dp_size(self.mesh)
        if self._envs_per_actor % dp:
            raise ValueError(f"num_envs/actor_threads={self._envs_per_actor} not divisible by "
                             f"dp={dp}")
        sp = self.mesh.shape.get(TIME_AXIS, 1)
        if config.unroll_len % sp:
            raise ValueError(f"unroll_len={config.unroll_len} not divisible by the time-shard "
                             f"axis sp={sp}")
        validate_ppo_geometry(config, self._envs_per_actor // dp, "per-device",
                              unroll=config.unroll_len // sp, recurrent=is_recurrent(self.model))
        self.learner = RolloutLearner(config, self.spec, self.model, self.mesh)
        self.state: LearnerState = self.learner.init_state(config.seed)
        self._ckpt, self.env_steps = checkpoint.setup(config, restore, self.state)
        self.checkpointer = self._ckpt.checkpointer

        self._inference_fn = make_inference_fn(self.model, self.spec, config)
        if config.introspect:
            # First-call-per-shape accounting on the inference entry point
            # (obs/introspect.py), wrapped ONCE here, before any server or
            # actor takes it, so the count spans supervised server rebuilds;
            # infer_recompile counts the batch shapes the actors' inference
            # saw. The params argument is skipped.
            self._inference_fn = introspect.instrument(
                self._inference_fn, "infer",
                counters=("compiles", "infer_recompile"),
                ignore_argnums=(0,),
            )
        # Per-window off-policy staleness (obs/introspect.py): one lag per
        # consumed fragment, drained at the window close.
        self._staleness = introspect.StalenessWindow() if config.introspect else None
        self._initial_core = (functools.partial(self.model.initial_core, device=self.device)
                              if is_recurrent(self.model) else None)
        self._store = ParamStore(self._published(self.state), self.env_steps)
        cap = config.queue_capacity or 2 * config.actor_threads
        self._queue: "queue.Queue[Fragment]" = queue.Queue(maxsize=cap)
        from asyncrl_tpu_torch.rollout import staging

        # One source of slab geometry, for the staging ring and the replay
        # ring.
        template = staging.fragment_template(config, self.spec, self.model,
                                             self._envs_per_actor)
        # Staging slabs the actors write into (pinned on CUDA, so the
        # drain's copies are asynchronous); overlap_h2d=False copies each
        # fragment out of its actor's buffer and stacks them instead. Under
        # the elastic runtime the ring sits behind a RingSwapHolder, so a
        # scale event can install a ring sized to the new fleet while the
        # open leases finish on the old one.
        self._staging = None
        self._staging_template = None
        self._staging_rows = max(config.updates_per_call, 1)
        self._staging_pinned = self.device.type == "cuda"
        if config.overlap_h2d:
            self._staging_template = template
            K = self._staging_rows
            ring = staging.StagingRing(
                template,
                rows_per_slab=K,
                num_slabs=config.staging_slabs or staging.auto_num_slabs(
                    cap, config.actor_threads, K),
                pin_memory=self._staging_pinned,
            )
            self._staging = staging.RingSwapHolder(ring) if self._elastic_on else ring
        # The device tier: slots between the copy and the update. "auto"
        # is on where the learner's device is not the host's.
        dq = config.device_queue
        if dq == "auto":
            dq = "on" if self.device.type == "cuda" else "off"
            config = config.replace(device_queue=dq)
            self.config = config
        if dq not in ("on", "off"):
            raise ValueError(f"unknown device_queue {config.device_queue!r}; expected auto|on|off")
        self._device_queue = None
        if dq == "on":
            from asyncrl_tpu_torch.rollout.device_queue import DeviceRolloutQueue

            self._device_queue = DeviceRolloutQueue(
                self.learner.put_rollout, slots=config.device_queue_slots, device=self.device)
        # The device replay ring (learn/replay.py): replay off builds none of
        # it. Row selection draws from a generator seeded as the JAX
        # package's, so both rings pick the same rows for the same history.
        self._replay = None
        self._reuse_window = None
        self._replay_rng = None
        self._stall_history = None
        if config.replay_slabs > 0:
            self._replay = replay_lib.DeviceReplayRing(template, rows=config.replay_slabs,
                                                       device=self.device)
            self._reuse_window = replay_lib.ReuseWindow()
            self._replay_rng = np.random.default_rng(config.seed * 9973 + 13)
            # Trailing stall fractions for learner_stall_trend.
            self._stall_history = deque(maxlen=8)
        # Observability (obs/): resets the process-wide registry (a fresh
        # trainer never reports a predecessor's counters), arms span tracing
        # and the flight recorder per config.trace (ASYNCRL_TRACE wins) and
        # the request journal; the window drain (observe_window) and
        # close() drive the handle.
        self._obs = obs.setup(config)
        # The elastic controller (the policy) and the save -> reconfigure ->
        # restore barrier (the safety); elastic off builds neither.
        self._elastic = None
        self._elastic_barrier = None
        if self._elastic_on:
            from asyncrl_tpu_torch.obs import health as health_mod
            from asyncrl_tpu_torch.runtime import elastic as elastic_mod

            monitor = self._obs.monitor
            blame_fn = None
            if monitor is not None:

                def blame_fn():
                    # Called after observe_window advanced the monitor's
                    # close stamp: the closed window's length, or the span
                    # horizon collapses to the 1 s clamp.
                    stage, _ = monitor.bottleneck(elapsed=monitor.last_window_s)
                    return health_mod.blame_component(stage)

            emin, emax = self._elastic_bounds()
            self._elastic = elastic_mod.ElasticController(
                min_actors=emin,
                max_actors=emax,
                cooldown_windows=config.elastic_cooldown_windows,
                up_stall_frac=config.elastic_up_stall_frac,
                up_shed_rate=config.elastic_up_shed_rate,
                down_backpressure=config.elastic_down_backpressure,
                down_admission=config.elastic_down_admission,
                # The replay inversion (a full ring and a fed learner: fewer
                # actors would do), armed only when the ring exists.
                down_replay_fill=(elastic_mod.DOWN_REPLAY_FILL
                                  if config.replay_slabs > 0 else 0.0),
                blame_fn=blame_fn,
            )
            self._elastic_barrier = elastic_mod.ReconfigureBarrier(self._ckpt)
        # Debug mode: the transport invariants on drained fragments.
        self._seq_checker = FragmentSequenceChecker() if sync_debug_enabled() else None
        self._errors: "queue.Queue[tuple[int, int, BaseException]]" = queue.Queue()
        self._stop = threading.Event()
        self._actors: list[ActorThread] = []
        # Per-slot restart counters, stamped into fragments.
        self._actor_gens = [0] * config.actor_threads
        self._updates = 0
        # version -> update count at its publish, for param_lag; version 0
        # is the constructor's.
        self._published_updates: dict[int, int] = {0: 0}
        self._actor_restarts = 0
        self._recent_restarts: list[float] = []
        # The watchdog's retirements, apart from crashes: a fleet that
        # churns on stalls and one that crash-loops are different failures.
        self._recent_watchdog: list[float] = []
        # queue.Full retries of retired actors; the window adds the live
        # actors' own counters.
        self._backpressure_base = 0
        self._next_actor_seed = config.seed * 7919 + 1
        # Evaluation pools, cached per (num_episodes, seed).
        self._eval_pools: dict[tuple[int, int], Any] = {}
        # The shared inference server (inference_server=True), on a stop
        # event of its own, so that rebuilding it leaves the actors' cohort
        # alone; its restarts abort beyond 3 within the window.
        self._server = None
        self._server_stop = threading.Event()
        self._server_restarts = 0
        self._recent_server_restarts: list[float] = []
        # The current server's (rounds, rows) at the last window close.
        self._infer_snap = (0, 0)
        # The external gateway (serve/gateway.py): gateway_port=0 constructs
        # nothing, no thread and no registry key. On, it needs the serve
        # core (it routes through ServeCore's continuous batch) and a
        # feed-forward policy (a recurrent core or epsilons have no wire
        # protocol). Its backend outlives rebuilds (the serve-stale anchor),
        # and a rebuild binds the port the first spawn resolved.
        self._gateway = None
        self._gateway_backend = None
        self._gateway_tenants = None
        self._gateway_port: int | None = None
        self._gateway_restarts = 0
        self._recent_gateway_restarts: list[float] = []
        self._gateway_retry_at = 0.0  # a failed re-bind retries after this
        if config.gateway_port != 0:
            if not config.inference_server or not self._serve_core:
                raise ValueError(
                    "gateway_port != 0 requires inference_server=True and the serve core "
                    "(serve=True / ASYNCRL_SERVE=1): the gateway serves through ServeCore's "
                    "continuous batch"
                )
            if inference_mode(config, self.model) != "ff":
                raise ValueError(
                    "gateway_port != 0 requires a feed-forward policy (core='ff', algo != "
                    "'qlearn'): recurrent and epsilon inference have no wire protocol yet"
                )
            if config.gateway_deadline_ms <= 0:
                raise ValueError(
                    "gateway_deadline_ms must be > 0: it is the budget of requests without an "
                    f"X-Deadline-Ms header (got {config.gateway_deadline_ms})"
                )
            from asyncrl_tpu_torch.serve import gateway as gateway_mod

            # A malformed SLO matrix fails here, where the operator reads it.
            self._gateway_tenants = gateway_mod.parse_tenant_spec(config.gateway_tenant_spec)
        else:
            registry = faults.active()
            if registry is not None and registry.has_kind("netfault"):
                raise ValueError(
                    "fault spec arms a 'netfault' site but the gateway is off (gateway_port=0): "
                    "the scripted wire failure could never fire"
                )
        self._restore_run_state()

    def _restore_run_state(self) -> None:
        """The resume (``resume=True`` or ``ASYNCRL_RESUME``): ``checkpoint.
        setup`` restored the learner state; the restored step's ``run_state``
        restores the rest of the run, so that every counter is monotone
        across the process boundary. The elastic fleet size is applied when
        the fleet starts (``_restore_fleet``). Then every later save carries
        the run state (``TrainerCheckpointing.meta_fn``)."""
        config = self.config
        self._resume_fleet: int | None = None
        run_state = self._ckpt.restore_meta.get("run_state")
        if self._resume_on and run_state:
            self._updates = int(run_state.get("updates", 0))
            # The restored weights are this process's version 0, published
            # at the restored update count: without the rebase every resumed
            # fragment would lag by the whole count before the preemption.
            self._published_updates = {0: self._updates}
            self._next_actor_seed = int(run_state.get("next_actor_seed", self._next_actor_seed))
            self._actor_restarts = int(run_state.get("actor_restarts", 0))
            self._server_restarts = int(run_state.get("server_restarts", 0))
            self._gateway_restarts = int(run_state.get("gateway_restarts", 0))
            if self._rollback is not None:
                self._rollback.attempts = int(run_state.get("rollback_attempts", 0))
            fleet = int(run_state.get("actors_live", config.actor_threads))
            if self._elastic_on and fleet != config.actor_threads:
                emin, emax = self._elastic_bounds()
                self._resume_fleet = max(emin, min(emax, fleet))
            monitor = self._obs.monitor
            if monitor is not None:
                monitor.window_idx = int(run_state.get("window_idx", 0))
            if self._obs.store is not None:
                self._obs.store.annotate({
                    "event_type": "resume",
                    "restored_update": self._updates,
                    "env_steps": float(self.env_steps),
                    "actors": fleet,
                })
        # The fleet size the last stopped fleet ran at: stop() clears
        # self._actors before the drain's final save and the crash path's
        # finalize, which must not checkpoint a scaled fleet at the
        # configured size.
        self._last_live_fleet = self._resume_fleet or config.actor_threads
        self._ckpt.meta_fn = self._run_state

    def _elastic_bounds(self) -> tuple[int, int]:
        """The fleet bounds ``[min_actors, max_actors]``
        (``elastic_max_actors=0`` is twice ``actor_threads``): one
        definition for the validation and the controller."""
        cfg = self.config
        return cfg.elastic_min_actors, cfg.elastic_max_actors or 2 * cfg.actor_threads

    def _run_state(self) -> dict[str, Any]:
        """The run state every checkpoint's metadata carries (JAX's keys)."""
        monitor = self._obs.monitor
        return {
            "actors_live": len(self._actors) or self._last_live_fleet,
            "next_actor_seed": self._next_actor_seed,
            "updates": self._updates,
            "window_idx": monitor.window_idx if monitor is not None else 0,
            "rollback_attempts": self._rollback.attempts if self._rollback is not None else 0,
            "actor_restarts": self._actor_restarts,
            "server_restarts": self._server_restarts,
            "gateway_restarts": self._gateway_restarts,
        }

    def _published(self, state: LearnerState):
        """What actors act under: a snapshot of the weights, with the
        observation stats under ``normalize_obs``."""
        return snapshot_policy(state.params,
                               state.obs_stats if self.config.normalize_obs else None)

    # --------------------------------------------------------------- actors

    def _epsilon_fn(self, index: int):
        """Thread ``index``'s behaviour-epsilon schedule for Q-learning (None
        otherwise): its env slots take their rungs of the ladder, annealed by
        the trainer's global frame count as last published to the store,
        plus the thread's own frames since that publish times the thread
        count, so the anneal advances between publishes; never rising
        again once lowered (:func:`qlearn_epsilon_at_frames`, the JAX
        trainer's rule)."""
        cfg = self.config
        if cfg.algo != "qlearn":
            return None
        B = self._envs_per_actor
        gidx = index * B + np.arange(B, dtype=np.float32)
        store = self._store
        last = {"steps": store.env_steps(), "frames": 0, "anneal": 0.0}

        def epsilon_fn(thread_frames: int) -> np.ndarray:
            published = store.env_steps()
            if published != last["steps"]:
                last["steps"] = published
                last["frames"] = thread_frames
            frames = published + (thread_frames - last["frames"]) * max(cfg.actor_threads, 1)
            # The extrapolation can overshoot the others' progress; the next
            # publish must not raise epsilon again.
            frames = max(float(frames), last["anneal"])
            last["anneal"] = frames
            return qlearn_epsilon_at_frames(cfg, gidx, frames)

        return epsilon_fn

    def _spawn_actor(self, index: int) -> ActorThread:
        seed = self._next_actor_seed
        self._next_actor_seed += 104729
        pool = make_host_pool(self.config, self._envs_per_actor, seed=seed)
        inference_fn = (self._server.client(index) if self._server is not None
                        else self._inference_fn)
        actor = ActorThread(
            index=index,
            pool=pool,
            inference_fn=inference_fn,
            store=self._store,
            out_queue=self._queue,
            unroll_len=self.config.unroll_len,
            seed=seed,
            stop_event=self._stop,
            errors=self._errors,
            device=self.device,
            initial_core=self._initial_core,
            epsilon_fn=self._epsilon_fn(index),
            track_returns=self.config.normalize_returns,
            return_discount=self.config.gamma,
            generation=self._actor_gens[index],
            staging=self._staging,
        )
        actor.start()
        return actor

    def _start_actors(self) -> None:
        if self._actors:
            return
        # A fresh stop event per cohort (a zombie of an earlier cohort keeps
        # its set one), and bumped generations.
        self._stop = threading.Event()
        self._actor_gens = [g + 1 for g in self._actor_gens]
        if self.config.inference_server:
            self._spawn_server()
        if self.config.gateway_port != 0:
            self._spawn_gateway()
        self._actors = [self._spawn_actor(i) for i in range(self.config.actor_threads)]

    def _spawn_server(self) -> None:
        """(Re)build the shared inference server on a fresh stop event of
        its own: the serve core under ``serve=True`` (or ``ASYNCRL_SERVE=1``),
        else the coalescing ``InferenceServer``. Both have the same
        supervisor surface. Clients of a dead server raise into their
        actors, whose restarts take the new server's clients."""
        cfg = self.config
        self._server_stop = threading.Event()
        # A rebuilt server's draws are decorrelated from its predecessor's.
        seed = cfg.seed + 1_000_003 * self._server_restarts
        mode = inference_mode(cfg, self.model)
        # The live fleet, not the configured one: a rebuild after an elastic
        # scale-up covers every live client slot (a first build sees no
        # actors and takes the config's).
        num_clients = max(cfg.actor_threads, len(self._actors))
        if self._serve_core:
            from asyncrl_tpu_torch.serve.scheduler import ServeCore
            from asyncrl_tpu_torch.serve.slo import SLOGate

            self._server = ServeCore(
                self._inference_fn, store=self._store, num_clients=num_clients,
                stop_event=self._server_stop, mode=mode, seed=seed, device=self.device,
                deadline_ms=cfg.serve_deadline_ms,
                slo=SLOGate(p95_target_ms=cfg.serve_slo_p95_ms,
                            max_inflight=cfg.serve_max_inflight, shed=cfg.serve_shed),
            )
        else:
            from asyncrl_tpu_torch.rollout.inference_server import InferenceServer

            self._server = InferenceServer(
                self._inference_fn, self._store, num_clients=num_clients,
                stop_event=self._server_stop, seed=seed, mode=mode, device=self.device,
            )
        self._infer_snap = (0, 0)  # the new server's counters start at 0
        self._server.start()

    def _spawn_gateway(self) -> None:
        """(Re)build the external gateway. The backend persists across
        rebuilds: its serve-stale anchor must survive a gateway crash, the
        outage stale mode exists for. A rebuild binds the port the first
        spawn resolved (an ephemeral -1 included), so clients reconnect
        without re-discovery."""
        from asyncrl_tpu_torch.serve import gateway as gateway_mod

        cfg = self.config
        if self._gateway_backend is None:
            self._gateway_backend = gateway_mod.CoreBackend(
                core_fn=lambda: self._server, inference_fn=self._inference_fn,
                obs_shape=self.spec.obs_shape, seed=cfg.seed, device=self.device,
            )
        port = self._gateway_port if self._gateway_port is not None else cfg.gateway_port
        self._gateway = gateway_mod.ServeGateway(
            self._gateway_backend, port=port, bind_host=gateway_mod.env_host(cfg.gateway_host),
            tenants=self._gateway_tenants, default_deadline_ms=cfg.gateway_deadline_ms,
        ).start()
        self._gateway_port = self._gateway.port

    def _respawn_gateway(self) -> OSError | None:
        """A rebuild that cannot re-bind (the port taken during the outage)
        costs external availability only: training goes on and the
        supervisor retries after a 2 s backoff. Returns the bind error."""
        try:
            self._spawn_gateway()
        except OSError as e:
            self._gateway_retry_at = time.monotonic() + 2.0
            print(f"asyncrl_tpu_torch: gateway re-bind failed ({e}); external serving stays "
                  "down, retrying (training continues)", file=sys.stderr)
            return e
        return None

    def _supervise_gateway(self) -> None:
        """Rebuild a gateway whose serving thread died (a netfault crash, a
        serving-loop failure) on its own storm window; the actors are never
        touched. The first bind, in ``_start_actors``, stays loud: a taken
        port at start-up is a configuration error, not an outage."""
        if self._stop.is_set() or self.config.gateway_port == 0:
            return
        gateway = self._gateway
        if gateway is None:
            # A previous rebuild could not re-bind: retry, backed off.
            if time.monotonic() >= self._gateway_retry_at:
                self._respawn_gateway()
            return
        if gateway.is_alive() and gateway.fatal is None:
            return
        fatal = gateway.fatal
        flightrec.record("supervisor.gateway_restart", detail=f"{fatal!r}")
        self._gateway_restarts += 1
        obs_registry.counter("gateway_restarts").inc()
        self._storm_guard(self._recent_gateway_restarts, 3, "gateway", fatal)
        gateway.stop()
        self._gateway = None  # a failed re-spawn must not re-reap the dead one
        err = self._respawn_gateway()
        if err is not None:
            flightrec.record("supervisor.gateway_rebind_failed", detail=f"{err}")

    def _supervise(self) -> None:  # thread-entry: watchdog@learner
        """Rebuild a dead or hung inference server, then a dead gateway,
        retire and restart hung actors (the heartbeat watchdog), restart
        dead ones (a fresh pool each time), and abort if failures repeat
        within ``_RESTART_WINDOW_S``; an ``InvariantViolation`` aborts at
        once. The server comes first: actors blocked on a hung server must
        not be charged before it is rebuilt."""
        from asyncrl_tpu_torch.rollout.inference_server import InvariantViolation

        self._supervise_server()
        self._supervise_gateway()
        self._supervise_stalled_actors()
        try:
            while True:
                index, gen, err = self._errors.get_nowait()
                if isinstance(err, InvariantViolation):
                    # An integrity bug, not a transient fault: no restarts,
                    # and forensics like every other failure path.
                    flightrec.record("supervisor.invariant_abort",
                                     detail=f"actor {index} gen {gen}: {err!r}")
                    self.stop()
                    raise err
                if index >= len(self._actors) or gen != self._actor_gens[index]:
                    # A thread already replaced (the watchdog's retirement
                    # racing its own death report): one failure, one restart.
                    continue
                self._restart_actor(index, err)
        except queue.Empty:
            pass

    def _storm_guard(self, stamps: list[float], threshold: int, what: str,
                     cause: BaseException | None) -> None:
        """Record a restart in ``stamps`` and abort the run past
        ``threshold`` restarts within ``_RESTART_WINDOW_S``."""
        now = time.monotonic()
        stamps.append(now)
        stamps[:] = [t for t in stamps if now - t < self._RESTART_WINDOW_S]
        if len(stamps) > threshold:
            # The last forensics before the abort (a no-op unarmed).
            flightrec.record(
                "supervisor.storm_abort",
                detail=f"{what}: {len(stamps)} restarts in "
                f"{self._RESTART_WINDOW_S}s (cause: {cause!r})",
            )
            self.stop()
            raise RuntimeError(
                f"{what} failed repeatedly ({len(stamps)} restarts in "
                f"{self._RESTART_WINDOW_S}s)"
            ) from cause

    def _supervise_server(self) -> None:
        """Rebuild a server whose thread died (the cause in its ``_fatal``)
        or hung (a heartbeat older than ``stall_timeout_s``): its clients
        raise into their actors, whose restarts wire up to the new server.
        An ``InvariantViolation`` aborts instead. After the rebuild every
        actor's heartbeat is stamped anew, so that the outage is not
        charged to the actors blocked on it."""
        server = self._server
        if server is None or self._stop.is_set():
            return
        from asyncrl_tpu_torch.rollout.inference_server import InvariantViolation

        fatal = server._fatal
        if isinstance(fatal, InvariantViolation):
            flightrec.record("supervisor.invariant_abort", detail=f"server: {fatal!r}")
            self.stop()
            raise fatal
        timeout_s = self.config.stall_timeout_s
        hung = (timeout_s > 0 and server.is_alive()
                and time.monotonic() - server.heartbeat > timeout_s)
        if server.is_alive() and not hung:
            return
        # The cause is written just before the thread exits: once it is
        # dead, this read sees it.
        fatal = server._fatal or fatal
        if isinstance(fatal, InvariantViolation):
            flightrec.record("supervisor.invariant_abort", detail=f"server: {fatal!r}")
            self.stop()
            raise fatal
        flightrec.record("supervisor.server_restart", detail=f"hung={hung}: {fatal!r}")
        self._server_restarts += 1
        self._storm_guard(self._recent_server_restarts, 3, "inference server", fatal)
        self._server_stop.set()  # wake blocked clients and a stalled server
        server.join(timeout=5.0)
        if server.is_alive():
            print("asyncrl_tpu_torch: hung inference server did not join within 5s; "
                  "abandoning thread (its stop event stays set)", file=sys.stderr)
        self._spawn_server()
        # After the join, which can take seconds: an earlier stamp could
        # already be past stall_timeout_s.
        refreshed = time.monotonic()
        for actor in self._actors:
            actor.heartbeat = refreshed

    def _supervise_stalled_actors(self) -> None:
        """The heartbeat watchdog (``stall_timeout_s > 0``): an alive actor
        whose progress stamp is older than the timeout is hung (a crash
        would be in the error queue). It is retired through its own
        ``abandon`` event, joined for up to 1 s, and restarted under the
        watchdog's storm window. A thread still wedged after the join is
        left to exit at its next check: it can no longer produce, since its
        puts check the event and its lease is voided.

        No actor is charged while the shared server's own stamp is older
        than half the timeout (a live server stamps every 0.1 s): the actors
        blocked on a server that hangs go stale with it, some a round before
        its stamp, and the server's watchdog rebuilds it first."""
        timeout_s = self.config.stall_timeout_s
        if timeout_s <= 0 or not self._actors:
            return
        now = time.monotonic()
        server = self._server
        if server is not None and server.is_alive() and now - server.heartbeat > timeout_s / 2:
            return
        for index, actor in enumerate(self._actors):
            if not actor.is_alive() or now - actor.heartbeat <= timeout_s:
                continue  # a dead actor is the error queue's
            actor.abandon.set()
            actor.join(timeout=1.0)
            if actor.is_alive():
                print(f"asyncrl_tpu_torch: hung actor {actor.index} did not join within 1s; "
                      "abandoning thread (it exits at its next abandon-event check)",
                      file=sys.stderr)
            self._restart_actor(
                index, RuntimeError(f"actor {index} made no progress for more than "
                                    f"{timeout_s}s (heartbeat watchdog)"),
                reason="watchdog")

    def _restart_actor(self, index: int, err: BaseException | None,
                       reason: str = "crash") -> None:
        """Retire actor ``index`` (dead, or abandoned by the watchdog) and
        spawn its replacement. ``reason`` picks the storm window, "crash" or
        "watchdog"; more than 3 restarts an actor of the live fleet within
        either window abort the run. The flight recorder's dump comes first,
        so it holds every thread's spans as they were when the failure was
        seen."""
        flightrec.record(
            "supervisor.actor_restart",
            detail=f"actor {index} gen {self._actor_gens[index]} reason={reason}: {err!r}",
        )
        self._actor_restarts += 1
        stamps = self._recent_watchdog if reason == "watchdog" else self._recent_restarts
        self._storm_guard(stamps, 3 * max(1, len(self._actors)), f"actor {index} ({reason})",
                          err)
        self._actor_gens[index] += 1
        self._backpressure_base += self._actors[index].backpressure
        if self._staging is not None:
            # The retired thread's open lease: its row re-opens for the
            # replacement, and a late write from the zombie raises.
            lease = self._actors[index]._open_lease
            if lease is not None:
                self._staging.void(lease)
        self._actors[index] = self._spawn_actor(index)

    # -------------------------------------------------------------- elastic

    def _scale_up_actor(self) -> None:
        """Grow the fleet by one slot (window-close thread). The serve
        core's client slot registers first (``client(index)`` must not fail
        its bounds check), the thread spawns last: mutate-last, so a failing
        pool build seen by the barrier leaves the fleet as it was."""
        index = len(self._actors)
        while len(self._actor_gens) <= index:
            self._actor_gens.append(0)
        if self._server is not None:
            self._server.ensure_client(index)
        try:
            self._actors.append(self._spawn_actor(index))
        # lint: broad-except-ok(not a swallow: cleanup-and-reraise — the serve-client registration unwinds and the original failure propagates to the reconfigure barrier)
        except BaseException:
            # _spawn_actor registers the serve-client slot (client(index))
            # before the thread exists: a ghost registration would hold
            # every later dispatch's fill target one client high, each
            # batch waiting out its deadline on a client that never
            # submits. remove_client is idempotent.
            if self._server is not None:
                self._server.remove_client(index)
            raise

    def _scale_down_actor(self) -> None:
        """Retire the highest slot (window-close thread) through the
        watchdog's retirement path: the ``abandon`` event, the join, the
        lease void. The thread can only exit, and its voided open lease
        raises ``StaleLeaseError`` on a late write; fragments it already
        committed and queued keep valid leases and reach the learner. The
        slot's generation is bumped, so a late error of the retired thread
        (or a later regrow of the index) is never taken for the retired
        stream. Deliberate: it enters no storm window."""
        index = len(self._actors) - 1
        actor = self._actors[index]
        actor.abandon.set()
        actor.join(timeout=5.0)
        if actor.is_alive():
            print(f"asyncrl_tpu_torch: scaled-down actor {index} did not join within 5s; "
                  "abandoning thread (it exits at its next abandon-event check)",
                  file=sys.stderr)
        self._actors.pop()
        self._actor_gens[index] += 1
        self._backpressure_base += actor.backpressure
        if self._staging is not None:
            lease = actor._open_lease
            if lease is not None:
                self._staging.void(lease)
        if self._server is not None:
            # After the join: the actor can no longer submit, and the
            # removal wakes a batch-fill wait so that the fill target
            # shrinks to the smaller client set.
            self._server.remove_client(index)

    def _build_staging_ring(self, actor_count: int):
        """Allocate, without installing, a staging ring sized for
        ``actor_count`` (auto sizing only: an explicit ``staging_slabs`` is
        the operator's). None: no resize needed. The fallible (pinned)
        allocation lives here so the reconfigure action runs it before the
        fleet changes; ``RingSwapHolder.swap`` installs it."""
        if self._staging_template is None or self.config.staging_slabs:
            return None
        from asyncrl_tpu_torch.rollout import staging

        depth = staging.auto_num_slabs(self._queue.maxsize, actor_count, self._staging_rows)
        if depth == self._staging.num_slabs:
            return None
        return staging.StagingRing(
            self._staging_template,
            rows_per_slab=self._staging_rows,
            num_slabs=depth,
            pin_memory=self._staging_pinned,
        )

    def _elastic_step(self, window: dict[str, Any]) -> None:
        """One controller evaluation at the window close (the drain thread,
        beside the health monitor). A decision runs inside the barrier and
        is recorded where a crash would be: the flight recorder, the
        registry's counters and the time-series store."""
        decision = self._elastic.decide(window, len(self._actors))
        if decision is None:
            return
        before = len(self._actors)
        flightrec.record(
            f"elastic.scale_{decision.direction}",
            detail=f"{decision.reason}: {decision.detail} "
            f"(fleet {before} {decision.delta:+d})",
        )

        def reconfigure():
            # One slot a decision, mutate-last across the whole action: the
            # ring's fallible allocation comes before the fleet changes, and
            # the swap installs it only after the slot operation succeeded.
            # A failure anywhere leaves the fleet and the data path as they
            # were; an unused new ring is just collected.
            new_ring = self._build_staging_ring(before + decision.delta)
            if decision.delta > 0:
                self._scale_up_actor()
            else:
                self._scale_down_actor()
            if new_ring is not None:
                self._staging.swap(new_ring)

        with trace.span(span_names.ELASTIC_RECONFIGURE):
            self.state, self.env_steps, ok = self._elastic_barrier.run(
                self.state, self.env_steps, reconfigure)
        if not ok:
            # A rolled-back scale is not a scale: only this counter records
            # the attempt.
            obs_registry.counter("elastic_reconfigure_failed").inc()
            flightrec.record(
                "elastic.reconfigure_failed",
                detail=f"restored checkpoint barrier; fleet stays at "
                f"{len(self._actors)}",
            )
            return
        obs_registry.counter(f"elastic_scale_{decision.direction}").inc()
        if self._obs.store is not None:
            self._obs.store.annotate(decision.event(before, len(self._actors)))

    def _advance_updates(self, n: int) -> None:
        """Advance the update counter by ``n`` and publish at every crossed
        ``actor_staleness`` boundary."""
        before = self._updates
        self._updates += n
        staleness = max(self.config.actor_staleness, 1)
        if before // staleness != self._updates // staleness:
            version = self._store.publish(self._published(self.state), self.env_steps)
            self._published_updates[version] = self._updates
            # Older versions than the deepest in-flight fragment's are
            # unreachable.
            for old in [v for v in self._published_updates
                        if v < version - 4 * (self._queue.maxsize + 2)]:
                del self._published_updates[old]

    def _replay_passes(self, pending: list) -> None:
        """The IMPACT reuse phase after each fresh update: up to
        ``replay_passes - 1`` least-reused ring rows, each one more update,
        publishing on the same cadence as fresh ones. ``env_steps`` does not
        advance: no new env data was consumed."""
        cfg = self.config
        period = max(cfg.target_update_period, 1)
        for _ in range(cfg.replay_passes - 1):
            rlease = self._replay.lease_sample(self._replay_rng)
            if rlease is None:
                break
            try:
                replayed, reuse, behaviour = rlease.consume()
            except replay_lib.ReplayStaleError:
                continue
            self.state, metrics = self.learner.update(self.state, replayed)
            pending.append(metrics)
            # Observed before the counter advances, as the fresh path's lag:
            # the replay pass right after a fresh consumption at lag L
            # reports L + 1.
            if self._staleness is not None:
                self._staleness.observe(self._updates - behaviour)
            self._reuse_window.observe(reuse, self._updates % period)
            self._advance_updates(1)

    def _infer_coalesce_window(self) -> dict[str, float]:
        """Mean request rows a round the current server served since the
        last window close ({} without a server)."""
        server = self._server
        if server is None:
            return {}
        rounds, rows = server.coalesce_rounds, server.coalesce_rows
        d_rounds, d_rows = rounds - self._infer_snap[0], rows - self._infer_snap[1]
        self._infer_snap = (rounds, rows)
        return {"infer_coalesce_batch": d_rows / d_rounds if d_rounds else 0.0}

    def _serving_window(self) -> dict[str, float]:
        """The fleet's window keys: the liveness gauges (``actors_live``,
        ``servers_live``, ``staging_slabs_live``, and gateway_live and
        gateway_restarts only with the gateway configured, so that
        gateway_port=0 adds no key) and the fault counters. The gauges reach
        the window through the registry's snapshot (``observe_window``)."""
        obs_registry.gauge("actors_live").set(float(sum(a.is_alive() for a in self._actors)))
        obs_registry.gauge("servers_live").set(
            1.0 if self._server is not None and self._server.is_alive() else 0.0)
        obs_registry.gauge("staging_slabs_live").set(
            float(self._staging.num_slabs) if self._staging is not None else 0.0)
        out: dict[str, float] = {}
        if self.config.gateway_port != 0:
            # From the config, not the object: an outage with a failed
            # re-bind (no gateway object) reads 0.0.
            obs_registry.gauge("gateway_live").set(
                1.0 if self._gateway is not None and self._gateway.is_alive() else 0.0)
            out["gateway_restarts"] = self._gateway_restarts
        out.update(faults.counters())
        return out

    def _drain_queue(self) -> None:
        """Discard queued fragments (through the transport checker when
        armed, so a discarded fragment still advances its stream)."""
        try:
            while True:
                fragment = self._queue.get_nowait()
                if self._seq_checker is not None:
                    self._seq_checker.check(fragment)
        except queue.Empty:
            pass

    def _quarantine_poisoned(self, slab_groups: dict, fragments: list) -> int:
        """Discard the fragments in flight, produced under (or poisoned by)
        a diverging policy: the queued ones through the transport checker
        with their staging leases voided (the rows re-open under fresh
        generations), the partial slab groups and the K-stack likewise. With
        the replay ring, every replay lease voids and the ring empties, with
        its telemetry. Returns the fragments quarantined."""
        staging = self._staging
        count = 0
        try:
            while True:
                fragment = self._queue.get_nowait()
                if self._seq_checker is not None:
                    self._seq_checker.check(fragment)
                if fragment.lease is not None and staging is not None:
                    staging.void(fragment.lease)
                count += 1
        except queue.Empty:
            pass
        for group in slab_groups.values():
            for fragment in group:
                if fragment.lease is not None and staging is not None:
                    staging.void(fragment.lease)
                count += 1
        slab_groups.clear()
        count += len(fragments)
        fragments.clear()
        if self._replay is not None:
            dropped = self._replay.quarantine()
            self._reuse_window.drain()
            self._stall_history.clear()
            if dropped:
                obs_registry.counter("replay_quarantined").inc(dropped)
        if count:
            obs_registry.counter("rollback_quarantined").inc(count)
        return count

    def _execute_rollback(self, action) -> None:
        """Restore the last good checkpoint (window-close thread): the steps
        saved after it are deleted first, so that the fallback restore
        cannot land on one written while the run diverged; the actor seed
        cursor folds, so that the stretch trained again draws other data;
        the restored weights publish at once. With no retained step the
        guard's held state goes on, and ``rollback.no_checkpoint`` is
        dumped."""
        ckpt = self._ckpt.checkpointer
        ckpt.wait()
        steps = sorted(ckpt.all_steps())
        if not steps:
            flightrec.record("rollback.no_checkpoint",
                             detail="rollback fired with no retained steps; "
                             "continuing on NaN-guard-held params")
            return
        last_good = self._rollback.last_good_step
        good = [s for s in steps if last_good is not None and s <= last_good]
        # The last good step rotated out by retention (or none banked yet):
        # the oldest retained step is the closest one left.
        target = good[-1] if good else steps[0]
        for step in steps:
            if step > target:
                ckpt.delete_step(step)
        self.env_steps = ckpt.restore(self.state)
        # The run trains from here again: reaching the restored step number
        # later, the save must replace the retained copy.
        ckpt.invalidate_restored()
        self._next_actor_seed += 104729 * 997
        version = self._store.publish(self._published(self.state), self.env_steps)
        self._published_updates[version] = self._updates

    def _rollback_step(self, agg: dict, slab_groups: dict, fragments: list) -> bool:
        """The policy's verdict on the closed window (the drain thread).
        True when an action fired."""
        monitor = self._obs.monitor
        if monitor is not None:
            events = [e for e in monitor.recent_events() if e.window_idx == monitor.window_idx]
        else:
            # No health monitor: the window's own divergence signal.
            events = []
            if any(isinstance(agg.get(key), float) and not np.isfinite(agg[key])
                   for key in ("loss", "grad_norm")):
                events.append(types.SimpleNamespace(detector="nonfinite_loss"))
        ckpt = self._ckpt.checkpointer
        action = self._rollback.on_window(
            events, ckpt.latest_step() if ckpt is not None else None)
        if action is None:
            return False
        counter = {"quarantine": "rollback_quarantine", "rollback": "rollback_restores",
                   "abort": "rollback_abort"}[action.kind]
        obs_registry.counter(counter).inc()
        flightrec.record(f"rollback.{action.kind}", detail=action.detail)
        if self._obs.store is not None:
            self._obs.store.annotate(action.event())
        if action.kind == "abort":
            self.stop()
            raise RuntimeError(f"divergence rollback attempts exhausted: {action.detail}")
        quarantined = self._quarantine_poisoned(slab_groups, fragments)
        print(f"asyncrl_tpu_torch: rollback policy: {action.kind} — {action.detail} "
              f"({quarantined} in-flight fragment(s) quarantined)", file=sys.stderr)
        if action.kind == "rollback":
            self._execute_rollback(action)
        return True

    def stop(self) -> None:
        """Stop the gateway, the actor threads and the inference server, and
        drain the queue."""
        self._stop.set()
        if self._gateway is not None:
            # The wire boundary closes first: external clients see
            # 503-draining, then a refused connection, rather than requests
            # dying behind them.
            self._gateway.close_admissions()
            self._gateway.stop()
            self._gateway = None
        # Before the joins: actors blocked on the server wake on its event.
        self._server_stop.set()
        self._drain_queue()  # unblock producers on a full queue
        for actor in self._actors:
            actor.join(timeout=5.0)
            if actor.is_alive():
                print(f"asyncrl_tpu_torch: actor {actor.index} did not join within 5s; "
                      "abandoning thread (it exits at its next stop-event check)")
        # Again after the joins: an actor mid-put can land one more.
        self._drain_queue()
        for actor in self._actors:
            self._backpressure_base += actor.backpressure
        if self._actors:
            self._last_live_fleet = len(self._actors)
        self._actors = []
        if self._server is not None:
            self._server.join(timeout=5.0)
            self._server = None
        if self._staging is not None:
            # Every lease goes stale and every slab frees.
            self._staging.reset()
        if self._replay is not None:
            # A new cohort starts on an empty ring and fresh telemetry.
            self._replay.quarantine()
            self._reuse_window.drain()
            self._stall_history.clear()
        if self._device_queue is not None:
            self._device_queue.reset()

    # ---------------------------------------------------------------- train

    def train(  # thread-entry: learner-drain@learner
        self,
        total_env_steps: int | None = None,
        callback: Callable[[dict[str, Any]], None] | None = None,
    ) -> list[dict[str, Any]]:
        """Drain fragments and update until ``total_env_steps`` env frames
        are consumed. Returns one metrics dict a window of ``log_every``
        update calls (see the module docstring)."""
        cfg = self.config
        target = total_env_steps or cfg.total_env_steps
        validate_train_target(cfg, target)
        steps_per_fragment = self._envs_per_actor * cfg.unroll_len
        history: list[dict[str, Any]] = []
        # The drain usually runs on MainThread: its span ring is tagged with
        # the pipeline stage, so reports and dumps say "learner".
        trace.tag_thread("learner")
        # The preemption drain (runtime/durability.py): with a grace budget,
        # SIGTERM/SIGINT route through the coordinator (its handlers install
        # on the main thread only; the scripted preempt kind reaches it
        # either way) and the loop polls one Event an iteration.
        drain = None
        if self._drain_grace > 0:
            drain = durability.DrainCoordinator(self._drain_grace, on_request=self._refuse_wire)
            drain.install()
            durability.set_active(drain)
        try:
            self._start_actors()
            self._restore_fleet()
        # lint: broad-except-ok(cleanup-and-reraise: the drain's handlers uninstall, then the start-up failure propagates unchanged)
        except BaseException:
            # The handlers and the registration must not outlive this call:
            # a later Ctrl-C would request a drain nothing polls.
            if drain is not None:
                _release_drain(drain)
            raise
        pending: list[dict[str, torch.Tensor]] = []
        ret_sum = len_sum = count = lag_sum = 0.0
        frag_count = 0
        window_start = time.perf_counter()
        window_steps = 0
        stall_s = h2d_wait_s = 0.0
        h2d_bytes = 0
        updates_at_eval = self._updates
        K = cfg.updates_per_call
        fragments: list[Fragment] = []
        # Staging: fragments grouped by slab until a slab has all K rows,
        # keyed by (minting ring, slab): after an elastic ring swap the old
        # ring's fragments and the new ring's never share a group.
        slab_groups: dict[tuple[Any, int], list[Fragment]] = {}
        ring = self._staging
        try:
            while self.env_steps < target:
                if drain is not None and drain.requested:
                    self._preempt_drain(drain, callback)  # raises PreemptedExit
                self._supervise()
                t_wait = time.perf_counter()
                try:
                    with trace.span(span_names.LEARNER_QUEUE_WAIT):
                        fragment = self._queue.get(timeout=1.0)
                except queue.Empty:
                    stall_s += time.perf_counter() - t_wait
                    continue
                stall_s += time.perf_counter() - t_wait
                if self._seq_checker is not None:
                    self._seq_checker.check(fragment)
                if ring is not None:
                    lease = fragment.lease
                    if lease is None or not lease.valid():
                        continue  # a retired actor's: its row is the replacement's
                    batch_ring = lease.ring
                    group_key = (batch_ring, lease.slab)
                    group = slab_groups.setdefault(group_key, [])
                    group.append(fragment)
                    if len(group) >= K:
                        # A lease can go stale after queueing; the voided
                        # row's replacement fragment completes the slab.
                        group[:] = [f for f in group if f.lease.valid()]
                    if len(group) < K:
                        continue
                    batch = sorted(slab_groups.pop(group_key), key=lambda f: f.lease.row)
                    slab_id = lease.slab
                    rollout = batch_ring.batch(slab_id)
                    nbytes = ring.slab_nbytes
                else:
                    fragments.append(fragment)
                    if len(fragments) < K:
                        continue
                    batch, fragments = fragments, []
                    slab_id = None
                    batch_ring = None
                    rollout = _stack_fragments([f.rollout for f in batch])
                    nbytes = int(sum(leaf.nbytes for leaf in rollout_leaves(rollout)))

                t_put = time.perf_counter()
                dlease = None
                try:
                    with trace.span(span_names.LEARNER_H2D_WAIT):
                        if self._device_queue is None:
                            rollout_d = self.learner.put_rollout(rollout)
                            copied = _record_event(self.device)
                        else:
                            dlease = self._device_queue.enqueue(rollout)
                            rollout_d, copied = dlease.rollout(), dlease.copied
                        if ring is not None and copied is not None:
                            # The transfer barrier: while the previous update
                            # still runs, so h2d_wait_s is the copy time it
                            # did not hide.
                            copied.synchronize()
                    h2d_wait = time.perf_counter() - t_put
                    h2d_wait_s += h2d_wait
                    # The per-update distribution of that time: p50/p95/max
                    # in the window beside the h2d_wait_s sum.
                    obs_registry.histogram("h2d_wait_ms").observe(1e3 * h2d_wait)
                    h2d_bytes += nbytes
                    if copied is not None:
                        torch.cuda.current_stream(self.device).wait_event(copied)
                    if cfg.reward_scale != 1.0 or cfg.step_cost != 0.0:
                        # The learner's view of the raw host rewards: the
                        # living cost, then the scale (the discounted-return
                        # stream is scaled, not cost-shifted), in the JAX
                        # drain's order of f32 operations.
                        rollout_d = dataclasses.replace(
                            rollout_d,
                            rewards=(rollout_d.rewards - cfg.step_cost) * cfg.reward_scale,
                            disc_returns=(None if rollout_d.disc_returns is None
                                          else rollout_d.disc_returns * cfg.reward_scale),
                        )
                    if self._replay is not None:
                        # The fresh slab enters the ring before its update,
                        # copied on this stream after the copy it waited for;
                        # the fresh pass is the row's first consumption.
                        self._replay.publish(rollout_d, behaviour_update=self._published_updates.get(
                            batch[0].version, self._updates))
                        self._reuse_window.observe(
                            1, self._updates % max(cfg.target_update_period, 1))
                    self.state, metrics = self.learner.update(self.state, rollout_d)
                # lint: broad-except-ok(cleanup-and-reraise: the held device lease voids so its slot cannot leak, then the failure propagates unchanged)
                except BaseException:
                    if dlease is not None:
                        dlease.void()
                    raise
                if dlease is not None:
                    # The slot is rewritten only once this update has run.
                    dlease.consume(_record_event(self.device))
                if batch_ring is not None:
                    # The slab is rewritten only once its copy has landed
                    # (on the CPU the update read it and has returned), and
                    # frees on the ring that minted it.
                    batch_ring.retire(slab_id, copied)
                self.env_steps += steps_per_fragment * K
                window_steps += steps_per_fragment * K
                pending.append(metrics)
                for i, f in enumerate(batch):
                    ret_sum += f.return_sum
                    len_sum += f.length_sum
                    count += f.count
                    # The fragment's policy lag in learner updates: consumed
                    # by update self._updates + i, its policy published at
                    # the recorded update count of its version.
                    lag = (self._updates + i) - self._published_updates.get(
                        f.version, self._updates)
                    lag_sum += lag
                    frag_count += 1
                    if self._staleness is not None:
                        self._staleness.observe(lag)
                self._advance_updates(K)
                if self._replay is not None:
                    self._replay_passes(pending)
                self._ckpt.after_update(self.state, self.env_steps)

                if len(pending) < cfg.log_every and self.env_steps < target:
                    continue
                with trace.span(span_names.LEARNER_METRICS):
                    drained = {k: torch.stack([m[k] for m in pending]).cpu().numpy()
                               for k in pending[0]}
                pending = []
                elapsed = time.perf_counter() - window_start
                window_start = time.perf_counter()
                agg = {k: float(np.mean([np.mean(row) for row in v])) for k, v in drained.items()}
                agg["episode_count"] = count
                agg["episode_return"] = ret_sum / max(count, 1.0)
                agg["episode_length"] = len_sum / max(count, 1.0)
                agg["param_lag"] = lag_sum / max(frag_count, 1)
                agg["env_steps"] = self.env_steps
                agg["fps"] = window_steps / max(elapsed, 1e-9)
                agg["actor_restarts"] = self._actor_restarts
                agg["server_restarts"] = self._server_restarts
                agg["queue_backpressure"] = self._backpressure_base + sum(
                    a.backpressure for a in self._actors)
                agg["h2d_wait_s"] = h2d_wait_s
                agg["h2d_bytes"] = h2d_bytes
                agg["learner_stall_frac"] = min(stall_s / max(elapsed, 1e-9), 1.0)
                if ring is not None:
                    agg["slab_reuse_waits"] = ring.reuse_waits
                if self._device_queue is not None:
                    agg["devq_reuse_waits"] = self._device_queue.reuse_waits
                # The window's staleness distribution, the per-fragment lags
                # behind the param_lag mean; the first-call counters ride
                # the registry snapshot of observe_window.
                if self._staleness is not None:
                    agg.update(self._staleness.drain())
                if "nonfinite_skip" in agg:
                    # The NaN guard's per-update flags fold into one
                    # cumulative count (their mean would read as a fraction).
                    self._nonfinite_skips += float(np.sum(drained["nonfinite_skip"]))
                    del agg["nonfinite_skip"]
                    agg["nonfinite_skips"] = self._nonfinite_skips
                if self._replay is not None:
                    # Replay off leaks none of these keys.
                    agg["replay_fill_frac"] = self._replay.fill_frac()
                    agg.update(self._reuse_window.drain())
                    hist = self._stall_history
                    agg["learner_stall_trend"] = (
                        agg["learner_stall_frac"] - sum(hist) / len(hist) if hist else 0.0)
                    hist.append(agg["learner_stall_frac"])
                agg.update(self._infer_coalesce_window())
                agg.update(self._serving_window())
                ret_sum = len_sum = count = lag_sum = 0.0
                frag_count = window_steps = h2d_bytes = 0
                stall_s = h2d_wait_s = 0.0
                # The in-training eval on the log boundary; the actors keep
                # filling the queue meanwhile, so its time counts against
                # the next window rather than inflating its rate.
                if cfg.eval_every > 0 and self._updates - updates_at_eval >= cfg.eval_every * K:
                    updates_at_eval = self._updates
                    with trace.span(span_names.LEARNER_EVAL):
                        agg["eval_return"] = self.evaluate(num_episodes=cfg.eval_episodes)
                    self._ckpt.maybe_save_best(self.state, self.env_steps, agg["eval_return"])
                # The one registry snapshot (with the tracer's stats), after
                # the eval, as every sink sees it.
                self._obs.observe_window(agg)
                # The divergence rollback first: a window the divergence
                # poisoned must not also drive a fleet decision.
                remediated = False
                if self._rollback is not None:
                    remediated = self._rollback_step(agg, slab_groups, fragments)
                # The elastic controller reads the window the sinks saw and
                # may move the fleet here, between updates, on this thread.
                if self._elastic is not None and not remediated:
                    self._elastic_step(agg)
                history.append(agg)
                if callback:
                    callback(agg)
        finally:
            self.stop()
            # A crash (an actor crash loop included) must not lose progress.
            # After a drain this save is a no-op: the step is already saved.
            self._ckpt.finalize(self.state, self.env_steps)
            # Flight dumps still queued reach the disk (the Perfetto export
            # is close()'s, once: forensics of a crash are the dumps').
            self._obs.close()
            if drain is not None:
                # On every way out: the watchdog disarmed, the previous
                # handlers back, the scripted-preempt registration dropped.
                _release_drain(drain)
        return history

    def _restore_fleet(self) -> None:
        """The resume: grow or shrink the just-started fleet to the
        checkpointed size one slot at a time through the executors a live
        scale uses, the staging ring resized after each, so that a run
        preempted at a scaled fleet resumes at that fleet."""
        target = self._resume_fleet
        if target is None:
            return
        self._resume_fleet = None
        before = len(self._actors)
        while len(self._actors) != target:
            step = 1 if len(self._actors) < target else -1
            new_ring = self._build_staging_ring(len(self._actors) + step)
            if step > 0:
                self._scale_up_actor()
            else:
                self._scale_down_actor()
            if new_ring is not None:
                self._staging.swap(new_ring)
        flightrec.record(
            "durability.fleet_restored",
            detail=f"resume rebuilt the fleet at {target} actors "
            f"(configured {before})",
        )

    def _refuse_wire(self) -> None:
        """The drain's first edge, where the drain is requested (in the
        signal handler): the gateway answers 503 to every later request,
        before the train loop reaches its poll. Lock-free."""
        gateway = self._gateway
        if gateway is not None:
            gateway.refuse_admissions()

    def _preempt_drain(self, drain, callback) -> None:
        """The preemption drain, on the train thread within the grace (the
        coordinator's watchdog exits past it): close the gateway's
        admissions, then the serve gate's, so no request is admitted into a
        pipeline that drains under it; stop the actors and the servers
        (``stop``: the queue discarded, every staging lease stale); send
        the partial window, with ``drain_preempt: 1.0``, to the sinks; write
        one final checkpoint and wait for its writer; flush the flight
        recorder, whose ``supervisor.preempt`` dump this drain records first;
        raise :class:`PreemptedExit` (exit code 86)."""
        flightrec.record(
            "supervisor.preempt",
            detail=f"signal {drain.signum}: draining within {drain.grace_s:.0f}s, "
            f"then exiting {durability.EXIT_DRAINED}",
        )
        if self._gateway is not None:
            self._gateway.close_admissions()
        gate = getattr(self._server, "slo", None)
        if gate is not None:
            gate.close()
        self.stop()
        window: dict[str, Any] = {
            "env_steps": self.env_steps,
            "drain_preempt": 1.0,
            "actor_restarts": self._actor_restarts,
            "server_restarts": self._server_restarts,
        }
        if self.config.gateway_port != 0:
            window["gateway_restarts"] = self._gateway_restarts
        window.update(faults.counters())
        self._obs.observe_window(window)
        if callback:
            callback(window)
        if self._ckpt.checkpointer is not None:
            # Durable before exit 86: the writer thread has finished.
            self._ckpt.save_now(self.state, self.env_steps)
            self._ckpt.checkpointer.wait()
        self._obs.close()  # the flight recorder's queue on disk
        drain.finish()
        raise durability.PreemptedExit(drain.signum)

    def save_checkpoint(self) -> None:
        """Save the current learner state now (needs ``checkpoint_dir``); the
        writer thread writes it, ``checkpointer.wait()`` waits for it."""
        self._ckpt.save_now(self.state, self.env_steps)

    def close(self) -> None:
        """Stop the actors, release the serve-stale anchor and the pools,
        then write the rings' Perfetto export (tracing on) and flush the
        flight recorder."""
        self.stop()
        if self._gateway_backend is not None:
            # stop() keeps the backend across gateway rebuilds; the last
            # teardown releases its anchor leases.
            self._gateway_backend.close()
            self._gateway_backend = None
        for pool in self._eval_pools.values():
            _close(pool)
        self._eval_pools = {}
        self._ckpt.close()
        # Everything the rings still hold (the run's tail, every thread).
        self._obs.export_trace()
        self._obs.shutdown()

    # ----------------------------------------------------------------- eval

    def evaluate(
        self,
        num_episodes: int = 32,
        max_steps: int | None = None,
        seed: int = 1234,
        return_episodes: bool = False,
    ):
        """Mean greedy-policy return over ``num_episodes`` fresh host envs
        (``return_episodes=True``: the per-episode returns). Each env counts
        its first episode; the pools are cached per (num_episodes, seed)
        and reset to their seed every call."""
        if max_steps is None:
            max_steps = default_eval_max_steps(self.config)
        pool_key = (num_episodes, seed)
        pool = self._eval_pools.get(pool_key)
        if pool is None:
            pool = make_host_pool(self.config, num_episodes, seed=seed)
            # Evaluation steps outside the supervised pipeline: an armed
            # pool.step must not fire (nor spend its budget) here.
            disarm = getattr(pool, "disarm_faults", None)
            if disarm is not None:
                disarm()
            self._eval_pools[pool_key] = pool
        dist = for_config(self.config, self.spec)
        model = normalizing_apply(self.state.params, self.state.obs_stats)
        # A recurrent policy carries its core across steps, reset where the
        # previous step ended an episode.
        core = self._initial_core(num_episodes) if self._initial_core is not None else None
        done_prev = np.zeros((num_episodes,), bool)
        try:
            obs = pool.reset()
            ep_return = np.zeros((num_episodes,), np.float64)
            finished = np.zeros((num_episodes,), bool)
            final_return = np.zeros((num_episodes,), np.float64)
            with torch.inference_mode():
                for _ in range(max_steps):
                    obs_t = torch.as_tensor(obs).to(self.device)
                    if core is None:
                        dist_params, _ = model(obs_t)
                    else:
                        done_t = torch.as_tensor(done_prev).to(self.device)
                        dist_params, _, core = model(obs_t, reset_core(core, done_t))
                    obs, rew, term, trunc = pool.step(dist.mode(dist_params).cpu().numpy())
                    done_prev = np.logical_or(term, trunc)
                    ep_return += np.where(finished, 0.0, rew)
                    done = np.logical_or(term, trunc) & ~finished
                    final_return = np.where(done, ep_return, final_return)
                    finished |= done
                    if finished.all():
                        break
            final_return = np.where(finished, final_return, ep_return)
            if return_episodes:
                return final_return.astype(np.float32)
            return float(final_return.mean())
        # lint: broad-except-ok(not a swallow: evicts the broken eval pool from the cache, then re-raises)
        except BaseException:
            self._eval_pools.pop(pool_key, None)
            _close(pool)
            raise


def _release_drain(drain) -> None:
    drain.finish()
    drain.uninstall()
    durability.clear_active(drain)


def _use_elastic(config: Config) -> bool:
    """The elastic runtime on? ``ASYNCRL_ELASTIC`` wins over
    ``config.elastic`` when set, as ``ASYNCRL_SERVE`` does."""
    return _env_flag("ASYNCRL_ELASTIC", config.elastic)


def _use_serve_core(config: Config) -> bool:
    """The serving tier's ServeCore (True) or the coalescing
    InferenceServer for the shared server: ``ASYNCRL_SERVE`` wins over
    ``config.serve`` when set."""
    return _env_flag("ASYNCRL_SERVE", config.serve)


def _env_flag(var: str, default: bool) -> bool:
    """A boolean environment override: ``default`` when ``var`` is unset or
    empty, else false only for 0, false and no."""
    env = os.environ.get(var, "")
    if env:
        return env.lower() not in ("0", "false", "no")
    return default


def _close(pool) -> None:
    close = getattr(pool, "close", None)
    if close is not None:
        try:
            close()
        # lint: broad-except-ok(best-effort pool teardown; a failing close must not mask the path that led here)
        except Exception:
            pass
