"""Training configuration of the PyTorch port.

Counterpart of ``asyncrl_tpu/utils/config.py``, holding only the fields the
port runs today: the Anakin A3C, IMPALA, PPO + GAE and async n-step
Q-learning trainers, feed-forward or with an LSTM core, on ``CartPole-v1``,
``JaxPong-v0``, ``JaxPongDuel-v0`` (self-play against a frozen rival),
``JaxPongPixels-v0``, ``JaxBreakout-v0``, ``JaxBreakoutPixels-v0``,
``JaxPendulum-v0``, the MinAtar-style games ``JaxSpaceInvaders-v0``,
``JaxFreeway-v0``, ``JaxAsterix-v0`` and ``JaxSeaquest-v0``, the gridworlds
``JaxChaser-v0`` and ``JaxMaze-v0`` and the planar locomotion tasks
``JaxHopper-v0`` ... ``JaxHumanoid-v0`` (also on a data-parallel mesh of
ranks, in one process or across processes, or as a population), and the
host path's A3C, IMPALA, PPO and Q-learning, feed-forward or LSTM
(``backend="sebulba"`` and ``"cpu_async"``: actor threads stepping native,
gymnasium or registry env pools, with per-thread inference or the shared
inference server or the serving tier's ServeCore with its external
gateway, and IMPALA's device replay ring), with the ALE knobs
(frame skip, frame pooling, sticky actions), the MLP, Nature-CNN and
IMPALA-CNN torsos, Adam or RMSProp, observation and return normalization,
gradient accumulation with block remat, the trainer's linear LR, fused
update calls, entropy anneal, living cost, in-training eval, checkpoints,
fault injection, the host path's stall watchdog, elastic runtime, preemption
drain, crash-consistent resume and divergence rollback, and the host path's
tracing, flight recorder, request journal and run health (the time-series
store, the detectors and the ``/metrics`` endpoint). The field names and
defaults are the JAX package's, except the workload defaults (``env_id``, ``algo``),
which name the port's first slice. ``device`` is the port's own field; ``fused_scan`` and ``scan_impl``
name the port's kernels ("kernel" where the JAX package says "pallas").

Every other knob of the JAX ``Config`` is in :data:`LATER_KNOBS`:
:meth:`Config.replace` (and so ``make_agent``) accepts it at its JAX default,
which is the only behaviour the port has, and any other value raises
``NotImplementedError`` saying that it has no counterpart.
:func:`override` applies the command lines' ``key=value`` strings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from asyncrl_tpu_torch.parallel.mesh import dp_axes

# Knob -> the JAX default the port runs. Every field of the JAX Config is
# either a field here or a knob here. Neither knob has a counterpart: the
# checker of jax's shard_map, and buffer donation into a compiled step
# (PyTorch updates in place).
LATER_KNOBS: dict[str, Any] = {"smap_check": "auto", "donate_buffers": False}

SUPPORTED_ENVS = (
    "CartPole-v1", "JaxPong-v0", "JaxPongDuel-v0", "JaxPongPixels-v0", "JaxPendulum-v0",
    "JaxChaser-v0", "JaxMaze-v0", "JaxBreakout-v0", "JaxBreakoutPixels-v0",
    "JaxHopper-v0", "JaxWalker2d-v0", "JaxHalfCheetah-v0", "JaxAnt-v0", "JaxHumanoid-v0",
    "JaxSpaceInvaders-v0", "JaxFreeway-v0", "JaxAsterix-v0", "JaxSeaquest-v0",
)
SUPPORTED_ALGOS = ("a3c", "impala", "ppo", "qlearn")
BACKENDS = ("tpu", "sebulba", "cpu_async")
HOST_POOLS = ("auto", "native", "gym", "jax")
FUSED_SCANS = ("auto", "kernel", "plain", "lax")
GRAD_REDUCES = ("auto", "psum", "ring")
SCAN_IMPLS = ("auto", "associative", "sequential", "kernel", "kernel_dma")


@dataclasses.dataclass(frozen=True)
class Config:
    """Training configuration for one workload (see the JAX ``Config`` for
    the meaning of each shared field)."""

    # --- workload ---
    env_id: str = "JaxPong-v0"
    algo: str = "impala"  # "a3c" | "impala" | "ppo" | "qlearn"

    # --- rollout geometry ---
    num_envs: int = 64
    unroll_len: int = 32
    total_env_steps: int = 500_000

    # --- model ---
    torso: str = "mlp"  # "mlp" | "nature_cnn" | "impala_cnn"
    hidden_sizes: tuple[int, ...] = (64, 64)
    channels: tuple[int, ...] = (16, 32, 32)
    # Recurrent core after the torso: "ff" (none) or "lstm" (the A3C/IMPALA
    # LSTM agent; DRQN for algo="qlearn"), with core_size units. The
    # learner re-forwards each fragment from the carry it started from.
    core: str = "ff"
    core_size: int = 256

    # --- optimization (global-norm clip + Adam or RMSProp) ---
    # "adam", or "rmsprop" in optax's form: eps inside the square root,
    # second moment from 0 (learn/learner.py ClipRMSProp).
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    # "constant", or "linear": anneal from learning_rate to 0 over the run's
    # total_env_steps (learn/learner.py make_optimizer).
    lr_schedule: str = "constant"
    adam_eps: float = 1e-8
    rmsprop_decay: float = 0.99
    rmsprop_eps: float = 0.1
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    gae_lambda: float = 0.95

    # --- loss ---
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    # With entropy_anneal_steps > 0 the coefficient ramps linearly from
    # entropy_coef to entropy_coef_final over that many learner updates,
    # then holds (learn/learner.py entropy_coef_at). 0 = constant.
    entropy_coef_final: float = 0.0
    entropy_anneal_steps: int = 0
    # The learner's view of a reward is (r - step_cost) * reward_scale;
    # episode-return metrics and eval stay raw.
    reward_scale: float = 1.0
    step_cost: float = 0.0
    # Running observation normalization (ops/normalize.py): every forward
    # sees (obs - mean) / std under the stats from before the update, and
    # the stats fold the fragment in after it.
    normalize_obs: bool = False
    # Reward scaling by the running std of the per-env discounted return
    # (the mean is not subtracted), stats from before the update.
    normalize_returns: bool = False

    # --- IMPALA / V-trace ---
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    actor_staleness: int = 1

    # --- async n-step Q-learning (algo="qlearn") ---
    # actor_staleness is the target network's refresh period (>= 2). The
    # bootstrap is the target's Q at the online net's argmax (double_q) or
    # the target's max. Each env slot's final epsilon is eps_base ** (1 +
    # eps_alpha * i / (N - 1)), annealed from 1 over exploration_steps env
    # frames. huber_delta > 0 takes the Huber TD loss.
    double_q: bool = True
    eps_base: float = 0.4
    eps_alpha: float = 7.0
    exploration_steps: int = 100_000
    dueling: bool = False
    huber_delta: float = 0.0

    # --- PPO ---
    ppo_clip_eps: float = 0.2
    ppo_epochs: int = 4
    ppo_minibatches: int = 4

    # --- envs ---
    # The ALE knobs (envs/wrappers.py): each env step plays its action
    # frame_skip times (rewards summed, frozen at the episode's end); pixel
    # envs max-pool the window's last two raw frames with frame_pool; with
    # probability sticky_actions a raw step repeats the previous action.
    frame_skip: int = 1
    frame_pool: bool = False
    sticky_actions: float = 0.0
    pong_opponent: str = "tracker"
    pong_opponent_speed: float = 0.0
    pong_max_steps: int = 3000
    # Self-play ladder (needs a duel env, JaxPongDuel-v0): the rival paddle
    # is a frozen snapshot of the agent, promoted to the current weights
    # every selfplay_refresh updates.
    selfplay: bool = False
    selfplay_refresh: int = 200

    # --- runtime ---
    seed: int = 0
    # Learner updates per Learner.update call, with each metric stacked
    # [K]. Log, eval and checkpoint cadences count CALLS.
    updates_per_call: int = 1
    log_every: int = 20  # update calls between metric drains
    # In-training greedy eval: once eval_every calls have passed, on the
    # next log boundary, eval_episodes greedy episodes give the window's
    # eval_return. 0 = off.
    eval_every: int = 0
    eval_episodes: int = 32
    # Calls between periodic checkpoint saves (0: none, but with
    # checkpoint_dir set train() still saves once when it exits); a
    # checkpoint_dir that holds checkpoints is resumed from its latest.
    # checkpoint_best keeps the best in-training eval's state under
    # "<checkpoint_dir>-best" (needs checkpoint_dir and eval_every).
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    checkpoint_best: bool = False
    precision: str = "bf16_matmul"  # "f32" | "bf16_matmul"
    introspect: bool = True
    # Microbatching: the loss and its gradient over grad_accum chunks of
    # whole envs, summed into one optimizer step (not for PPO).
    grad_accum: int = 1
    # Recompute each residual block (the whole MLP torso) in the backward
    # pass instead of keeping its activations (torch.utils.checkpoint).
    remat: bool = False

    # --- parallelism ---
    # The data-parallel mesh of ranks (parallel/mesh.py): -1 takes every
    # device of the list make_mesh is given (the config's device once, by
    # default). Ranks that share one card are a mesh built by hand, e.g.
    # make_mesh((8,), devices=[torch.device("cuda")] * 8).
    mesh_shape: tuple[int, ...] = (-1,)
    mesh_axes: tuple[str, ...] = ("dp",)
    # Gradient all-reduce over the ranks: "psum" (a plain sum over the rank
    # axis), "ring" (the bidirectional ring of ops/ring_reduce.py, a fixed
    # summation order), or "auto", which resolve_scan_impl makes "psum".
    grad_reduce: str = "auto"

    # --- the host path (backend="sebulba" or "cpu_async") ---
    # "tpu" is the Anakin trainer (the envs on the device). "sebulba"
    # steps host env pools in actor threads and learns on the device
    # (api/sebulba_trainer.py); "cpu_async" is that on the CPU alone.
    backend: str = "tpu"
    actor_threads: int = 2  # host actor threads; each owns num_envs/threads envs
    queue_capacity: int = 0  # the actor->learner queue's bound; 0 = 2 * actor_threads
    # The host env pool: "native" (the C++ pool), "gym" (gymnasium), "jax"
    # (the JAX package's name for the registry env, stepped on the CPU), or
    # "auto", the first of them that has the env.
    host_pool: str = "auto"
    # Actors write fragments into preallocated staging slabs (pinned on
    # CUDA) and the drain copies whole slabs (rollout/staging.py); off:
    # each fragment is copied out of its actor's buffer and stacked.
    overlap_h2d: bool = True
    staging_slabs: int = 0  # the staging ring's slabs; 0 = enough to never block
    # Device slots between the copy and the update (rollout/device_queue.py):
    # "auto" is "on" on CUDA and "off" on the CPU, where the learner reads
    # the host slab itself.
    device_queue: str = "auto"
    device_queue_slots: int = 2
    # The shared inference server: one batched call for every actor
    # thread's query instead of one a thread. serve=True takes the serving
    # tier's ServeCore (serve/scheduler.py: continuous batching, the SLO
    # gate, the policy router, zero-drain weight swaps); serve=False the
    # coalescing InferenceServer (rollout/inference_server.py).
    # ASYNCRL_SERVE, when set, wins over serve, read once when the trainer
    # is built.
    inference_server: bool = False
    serve: bool = True
    # The serve core's batch-fill deadline, ms: a batch dispatches when
    # every registered client of its policy has a request in, or when the
    # oldest request has waited this long, whichever comes first.
    serve_deadline_ms: float = 2.0
    # SLO target on the rolling p95 serve latency, ms (0 = off): in breach
    # the admission gate sheds (serve_shed=True) or backpressures.
    serve_slo_p95_ms: float = 0.0
    # Cap on admitted-but-unfinished requests (0 = uncapped).
    serve_max_inflight: int = 0
    # Overload response: refuse (RequestShed) or block the client. Actor
    # threads keep False: they must slow down, not crash.
    serve_shed: bool = False
    # The external gateway (serve/gateway.py): /v1/act and /v1/evaluate
    # over HTTP, with deadline propagation, per-tenant SLO classes and
    # graceful degradation. 0 = off, and nothing is constructed; -1 binds
    # an ephemeral port (read back from the trainer); positive binds there.
    # Needs inference_server=True, the serve core and a feed-forward
    # policy. ASYNCRL_GATEWAY_HOST wins over gateway_host when set.
    gateway_port: int = 0
    gateway_host: str = "127.0.0.1"
    # The budget of a request without an X-Deadline-Ms header, ms.
    gateway_deadline_ms: float = 1000.0
    # Per-tenant SLO classes, "name:mode[:k=v,...]" ';'-separated (modes
    # shed|stale|fallback; options p95_ms, inflight, rps, burst, fallback).
    gateway_tenant_spec: str = ""
    # The heartbeat watchdog of the host path: an actor thread or the
    # inference server whose progress stamp is older than this many seconds
    # is hung, and is restarted like a crashed one (in a storm window of its
    # own). 0 turns the watchdog off, the default: a restarted actor's first
    # steps (a stream, a generator and a cuBLAS handle) take a while, so
    # enable it with a margin over the measured step time.
    stall_timeout_s: float = 0.0
    # Fault injection (utils/faults.py), "site:kind:prob:seed[:k=v,...]"
    # ';'-separated; ASYNCRL_FAULTS wins when set. Empty = unarmed.
    fault_spec: str = ""
    # --- the elastic runtime (runtime/elastic.py; the host path) ---
    # An ElasticController evaluated at each window close grows or shrinks
    # the actor fleet (and resizes the staging ring behind a checkpoint
    # barrier) from the windows' signals; the fault spec's scale kind
    # scripts it. Needs updates_per_call=1 and, with inference_server=True,
    # the serve core. ASYNCRL_ELASTIC wins when set. Off constructs nothing
    # elastic and adds no elastic_* key to a window.
    elastic: bool = False
    # Fleet bounds no decision (scripted or not) moves the fleet outside.
    elastic_min_actors: int = 1
    # 0 = twice actor_threads.
    elastic_max_actors: int = 0
    # Windows the controller stays quiet after each of its own actions
    # (scripted events skip the cooldown, never the bounds).
    elastic_cooldown_windows: int = 2
    # Scale up when learner_stall_frac exceeds this for the hysteresis run
    # (and the span blame, with a monitor mounted, names the actors); 1.0
    # turns the signal off.
    elastic_up_stall_frac: float = 0.5
    # Scale up when the gateway's shed counters grow by at least this much
    # a window (client pain; never vetoed by the blame); 0 = off.
    elastic_up_shed_rate: float = 0.0
    # Scale down when queue_backpressure grows by at least this much a
    # window (the actors outran the learner); 0 = off.
    elastic_down_backpressure: float = 1.0
    # Scale down when the serve gate's overload and shed counters grow by
    # at least this much a window (the actors outran the server); 0 = off.
    elastic_down_admission: float = 1.0
    # The preemption drain's grace budget, seconds (runtime/durability.py):
    # with > 0, SebulbaTrainer.train() turns SIGTERM/SIGINT (on the main
    # thread) into a drain that closes admissions, stops the actors, writes
    # one final checkpoint and exits EXIT_DRAINED (86); a watchdog exits
    # EXIT_DEADLINE (87) past the grace, and a second signal at once. 0
    # disables it. ASYNCRL_DRAIN_GRACE_S wins when set.
    drain_grace_s: float = 30.0
    # The crash-consistent resume (SebulbaTrainer; the Anakin trainer
    # ignores it, as JAX's does): on top of the learner state that
    # checkpoint_dir's auto-resume restores, the checkpoint's run_state
    # metadata restores the host counters, the staleness ledger rebased on
    # the restored update count, the actor seed cursor, the health
    # monitor's window cursor and the elastic fleet size, and
    # timeseries.jsonl goes on as a new segment opened by a resume event.
    # ASYNCRL_RESUME wins when set.
    resume: bool = False
    # The divergence rollback (SebulbaTrainer and RolloutLearner; the Anakin
    # trainer ignores both knobs, as JAX's does): with > 0, the learner's NaN
    # guard skips every update whose loss or gradient norm is not finite
    # (the whole state holds; the windows count nonfinite_skips), every bad
    # window (nonfinite_loss, grad_explosion, entropy_collapse) quarantines
    # the fragments in flight, and this many consecutive bad windows restore
    # the last good checkpoint (runtime/durability.py RollbackPolicy). Needs
    # checkpoint_dir. 0 (the default) is the program without the rollback.
    rollback_bad_windows: int = 0
    # Restores a run may make: the next bad streak past them aborts the run.
    rollback_max_attempts: int = 2
    # --- tracing and forensics (obs/; the host backends) ---
    # Pipeline tracing: per-thread span rings across the actor, server,
    # staging and learner stages, exported for Perfetto, with the flight
    # recorder armed alongside (dumps into run_dir on every fault fire and
    # supervisor restart). ASYNCRL_TRACE (when set) wins, like
    # ASYNCRL_FAULTS. Off = the no-op fast path (one None check a span).
    # The Anakin trainer (backend="tpu") spans nothing, as in JAX.
    trace: bool = False
    # Per-thread span ring capacity (drop-oldest on overflow, counted in
    # the trace_dropped_spans window key).
    trace_ring: int = 4096
    # Flight recorder lookback: seconds of spans a dump holds.
    trace_window_s: float = 10.0
    # Output directory of trace-*.json, flightrec-*.json and
    # requests.jsonl. Empty = runs/<env>-<algo>-s<seed>-<stamp>-<pid> when
    # tracing is on; ASYNCRL_RUN_DIR wins when set.
    run_dir: str = ""
    # Request hop journals (obs/requests.py) on the gateway's requests;
    # ASYNCRL_REQUEST_TRACE (when set) wins. At most request_journal_cap
    # journals persist to requests.jsonl; served (200) journals persist
    # only from request_sample_slow_ms on (<= 0: every one).
    request_trace: bool = False
    request_journal_cap: int = 512
    request_sample_slow_ms: float = 0.0
    # --- run health (obs/timeseries.py, obs/health.py, obs/http.py; the
    # host backends) ---
    # The exposition endpoint (/metrics, /healthz, /timeseries): 0 = off
    # (no thread), -1 = an OS-assigned ephemeral port (read it back from
    # agent._obs.http.port), positive = that port. ASYNCRL_OBS_PORT and
    # ASYNCRL_OBS_HOST win when set. The store and the detectors mount when
    # tracing is on or a port is set.
    obs_http_port: int = 0
    obs_http_host: str = "127.0.0.1"
    # Window samples the in-memory time-series ring keeps (drop-oldest;
    # timeseries.jsonl keeps them all).
    obs_timeseries_cap: int = 4096
    # Detector thresholds (obs/health.py; the doctor replays the values the
    # run recorded in its timeseries meta). learner_stall fires above
    # health_stall_frac; fps_collapse below health_fps_collapse x the run's
    # trailing median fps; an event keeps /healthz degraded for
    # health_window_ttl windows. The rest are 0 = off: grad_explosion
    # (grad_norm above), eval_regression (eval_return this far below the
    # run's best), entropy_collapse (entropy below), staleness_runaway
    # (staleness_max above), rho_clip_saturation (rho_clip_frac above),
    # recompile_storm (compiles grown by this many in one window) and
    # memory_growth (the memory watermark this fraction above the run's
    # first).
    health_stall_frac: float = 0.9
    health_fps_collapse: float = 0.5
    health_grad_norm_max: float = 0.0
    health_eval_drop: float = 0.0
    health_window_ttl: int = 3
    health_entropy_floor: float = 0.0
    health_staleness_max: float = 0.0
    health_rho_clip_frac: float = 0.0
    health_recompile_storm: int = 0
    health_mem_growth: float = 0.0
    # The device replay ring (learn/replay.py, IMPACT): the last
    # replay_slabs fragments stay on the device, and each fresh update is
    # followed by replay_passes - 1 replayed ones (algo="impala",
    # updates_per_call=1, core="ff", no normalization; 0 = off). Every
    # update then floors the behaviour log-prob at log pi_target -
    # log(replay_rho_clip) under a target network refreshed every
    # target_update_period updates. ASYNCRL_REPLAY, when set, wins over
    # replay_slabs, read once when the trainer is built.
    replay_slabs: int = 0
    replay_passes: int = 2
    target_update_period: int = 100
    replay_rho_clip: float = 2.0

    # --- the port's own ---
    # Where the trainer runs. "cuda" needs a GPU and raises without one; the
    # CPU runs only when asked for.
    device: str = "cuda"

    # --- the V-trace/GAE kernels ---
    # The V-trace/GAE tail: "kernel" (the fused CUDA kernel,
    # ops/fused_vtrace.py), "plain" (its plain PyTorch version), "auto" (the
    # kernel on CUDA, the plain version on the CPU), or "lax" (the unfused
    # elementwise path, whose reverse recurrence runs ``scan_impl``).
    fused_scan: str = "auto"
    # The reverse recurrence of the "lax" path (ops/scan.py): "associative"
    # (log-depth doubling in PyTorch), "sequential" (a loop with one fma a
    # step), "kernel" / "kernel_dma" (the CUDA scans of ops/linear_scan.py),
    # or "auto", which the learner resolves to "associative" as the JAX
    # package does. The two kernels need device="cuda", as
    # fused_scan="kernel" does.
    scan_impl: str = "auto"

    def __post_init__(self):
        if self.env_id not in SUPPORTED_ENVS and self.backend == "tpu":
            raise NotImplementedError(
                f"env_id={self.env_id!r} is not a built-in env of the port; a gymnasium env "
                f"runs on the host path (backend='sebulba' or 'cpu_async'); the Anakin "
                f"backend runs {SUPPORTED_ENVS}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected {'|'.join(BACKENDS)}")
        if self.host_pool not in HOST_POOLS:
            raise ValueError(
                f"unknown host_pool {self.host_pool!r}; expected {'|'.join(HOST_POOLS)}"
            )
        if self.algo not in SUPPORTED_ALGOS:
            raise NotImplementedError(
                f"algo={self.algo!r}: the port runs {SUPPORTED_ALGOS}, every algorithm of the "
                "JAX package"
            )
        if self.torso not in ("mlp", "nature_cnn", "impala_cnn"):
            raise ValueError(
                f"unknown torso {self.torso!r}; expected mlp|nature_cnn|impala_cnn"
            )
        if self.precision not in ("f32", "bf16_matmul"):
            raise ValueError(
                f"unknown precision {self.precision!r}; expected f32|bf16_matmul"
            )
        if self.fused_scan not in FUSED_SCANS:
            raise ValueError(
                f"unknown fused_scan {self.fused_scan!r}; expected {'|'.join(FUSED_SCANS)}"
            )
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(
                f"unknown scan_impl {self.scan_impl!r}; expected {'|'.join(SCAN_IMPLS)}"
            )
        if self.device == "cpu" and (
            self.fused_scan == "kernel" or self.scan_impl.startswith("kernel")
        ):
            raise ValueError(
                f"fused_scan={self.fused_scan!r}, scan_impl={self.scan_impl!r}: "
                "the CUDA kernels need device='cuda'"
            )
        if self.actor_staleness < 1:
            raise ValueError(f"actor_staleness={self.actor_staleness} must be >= 1")

    def replace(self, **kwargs: Any) -> "Config":
        """A copy with ``kwargs`` applied. JAX knobs the port does not have
        are accepted at their JAX default and refused otherwise."""
        fields = {f.name for f in dataclasses.fields(self)}
        for key in [k for k in kwargs if k not in fields]:
            if key not in LATER_KNOBS:
                raise KeyError(f"unknown config key: {key!r}; valid keys: {sorted(fields)}")
            default = LATER_KNOBS[key]
            value = kwargs.pop(key)
            if value != default:
                raise NotImplementedError(
                    f"{key}={value!r}: the port has no counterpart of this knob; "
                    f"only its JAX default {default!r} is accepted"
                )
        return dataclasses.replace(self, **kwargs)

    @property
    def batch_steps_per_update(self) -> int:
        return self.num_envs * self.unroll_len


def resolve_scan_impl(config: Config, mesh) -> Config:
    """``scan_impl="auto"`` resolved to "associative", as the JAX learner
    resolves it on every mesh (``fused_scan="auto"`` keeps its meaning:
    the tail runs where the tensors live), and ``grad_reduce`` checked and
    resolved as the JAX learner does: "auto" is "psum", and "ring" needs a
    single data-parallel axis of ``mesh`` (a ``parallel.mesh.Mesh``).

    The JAX learner also refuses "ring" on jax releases whose ``shard_map``
    reduces gradients implicitly, where a ring would reduce them twice. The
    port reduces once, explicitly, so that refusal has no counterpart here.
    """
    if config.grad_reduce not in GRAD_REDUCES:
        raise ValueError(
            f"unknown grad_reduce {config.grad_reduce!r}; expected {'|'.join(GRAD_REDUCES)}"
        )
    if config.grad_reduce == "auto":
        config = config.replace(grad_reduce="psum")
    axes = dp_axes(mesh)
    if config.grad_reduce == "ring" and len(axes) != 1:
        raise ValueError(
            f"grad_reduce='ring' needs a single data-parallel mesh axis, got {axes}; "
            "use grad_reduce='psum'"
        )
    if config.scan_impl != "auto":
        return config
    return config.replace(scan_impl="associative")


def default_eval_max_steps(config: Config) -> int:
    """Greedy-eval horizon containing the longest episode of the env:
    JaxPong's runs to ``pong_max_steps``, the others end well before 3200
    (CartPole at 500)."""
    if "JaxPong" in config.env_id:
        return max(3200, config.pong_max_steps + 200)
    return 3200


def _coerce(old: Any, raw: str) -> Any:
    """Parse ``raw`` to the type of ``old`` (bool/int/float/str/tuple), as
    the JAX package's ``_coerce`` does."""
    if isinstance(old, bool):
        if raw.lower() in ("1", "true", "yes"):
            return True
        if raw.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        items = [s for s in raw.strip("()[] ").split(",") if s.strip()]
        elem = old[0] if old else raw
        return tuple(type(elem)(s.strip()) if old else s.strip() for s in items)
    return raw


def override(config: Config, kvs: Mapping[str, str] | list[str]) -> Config:
    """Apply command-line ``key=value`` overrides to ``config`` (JAX
    ``override``). A value takes the type of the field's current value; a
    JAX knob of :data:`LATER_KNOBS` takes the type of its JAX default, so
    that its default parses and :meth:`Config.replace` refuses the rest."""
    pairs = dict(kv.split("=", 1) for kv in kvs) if isinstance(kvs, list) else dict(kvs)
    field_names = {f.name for f in dataclasses.fields(config)}
    updates = {}
    for key, raw in pairs.items():
        if key in field_names:
            old = getattr(config, key)
        elif key in LATER_KNOBS:
            old = LATER_KNOBS[key]
        else:
            raise KeyError(f"unknown config key: {key!r}; valid keys: {sorted(field_names)}")
        updates[key] = _coerce(old, raw)
    return config.replace(**updates)
