"""Training configuration of the PyTorch port.

Counterpart of ``asyncrl_tpu/utils/config.py``, holding only the fields the
port runs today: the Anakin A3C, IMPALA and PPO + GAE trainers on
``CartPole-v1``, ``JaxPong-v0``, ``JaxPongPixels-v0`` and ``JaxPendulum-v0``
(IMPALA also on a data-parallel mesh of ranks), with the trainer's linear
LR, fused update calls, entropy anneal, living cost, in-training eval and
checkpoints. The field names and defaults are the JAX package's, except the
workload defaults (``env_id``, ``algo``), which name the port's first
slice. ``device`` is the port's own field; ``fused_scan`` and ``scan_impl``
name the port's kernels ("kernel" where the JAX package says "pallas").

Every other knob of the JAX ``Config`` is in :data:`LATER_KNOBS`:
:meth:`Config.replace` (and so ``make_agent``) accepts it at its JAX default,
which is the only behaviour the port has, and any other value raises
``NotImplementedError`` naming the slice of the port that brings it
(``ROADMAP.md``, Queue A), or saying that it has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from asyncrl_tpu_torch.parallel.mesh import dp_axes

# Knob -> (the JAX default the port runs, the later slice that brings the
# rest). Every field of the JAX Config is either a field here or a knob here.
_ALGOS = "the other algorithms on Anakin (Queue A item 9)"
_ENVS = "the remaining envs (Queue A items 2, 8 and 10)"
_HOST = "the host path (Queue A item 12)"
_SERVE = "the serving tier (Queue A item 13)"
_RUNTIME = "the runtime and observability (Queue A item 14)"
_LSTM = "LSTM cores (Queue A item 9)"
_QLEARN = "qlearn (Queue A item 9)"
_NOTHING = "nothing"
LATER_KNOBS: dict[str, tuple[Any, str]] = {
    "backend": ("tpu", _HOST),
    "core": ("ff", _LSTM),
    "core_size": (256, _LSTM),
    "optimizer": ("adam", _ALGOS),
    "rmsprop_decay": (0.99, _ALGOS),
    "rmsprop_eps": (0.1, _ALGOS),
    "normalize_obs": (False, _ALGOS),
    "normalize_returns": (False, _ALGOS),
    "double_q": (True, _QLEARN),
    "eps_base": (0.4, _QLEARN),
    "eps_alpha": (7.0, _QLEARN),
    "exploration_steps": (100_000, _QLEARN),
    "dueling": (False, _QLEARN),
    "huber_delta": (0.0, _QLEARN),
    "frame_pool": (False, _ENVS),
    "sticky_actions": (0.0, _ENVS),
    "selfplay": (False, _ALGOS),
    "selfplay_refresh": (200, _ALGOS),
    "grad_accum": (1, _ALGOS),
    "remat": (False, "the pixel flagship's remat (Queue A item 8)"),
    "actor_threads": (2, _HOST),
    "queue_capacity": (0, _HOST),
    "host_pool": ("auto", _HOST),
    "inference_server": (False, _HOST),
    "overlap_h2d": (True, _HOST),
    "staging_slabs": (0, _HOST),
    "device_queue": ("auto", _HOST),
    "device_queue_slots": (2, _HOST),
    "replay_slabs": (0, _HOST),
    "replay_passes": (2, _HOST),
    "target_update_period": (100, _HOST),
    "replay_rho_clip": (2.0, _HOST),
    "serve": (True, _SERVE),
    "serve_deadline_ms": (2.0, _SERVE),
    "serve_slo_p95_ms": (0.0, _SERVE),
    "serve_max_inflight": (0, _SERVE),
    "serve_shed": (False, _SERVE),
    "gateway_port": (0, _SERVE),
    "gateway_host": ("127.0.0.1", _SERVE),
    "gateway_deadline_ms": (1000.0, _SERVE),
    "gateway_tenant_spec": ("", _SERVE),
    "elastic": (False, _RUNTIME),
    "elastic_min_actors": (1, _RUNTIME),
    "elastic_max_actors": (0, _RUNTIME),
    "elastic_cooldown_windows": (2, _RUNTIME),
    "elastic_up_stall_frac": (0.5, _RUNTIME),
    "elastic_up_shed_rate": (0.0, _RUNTIME),
    "elastic_down_backpressure": (1.0, _RUNTIME),
    "elastic_down_admission": (1.0, _RUNTIME),
    "drain_grace_s": (30.0, _RUNTIME),
    "resume": (False, _RUNTIME),
    "rollback_bad_windows": (0, _RUNTIME),
    "rollback_max_attempts": (2, _RUNTIME),
    "stall_timeout_s": (0.0, _RUNTIME),
    "fault_spec": ("", _RUNTIME),
    "trace": (False, _RUNTIME),
    "trace_ring": (4096, _RUNTIME),
    "trace_window_s": (10.0, _RUNTIME),
    "run_dir": ("", _RUNTIME),
    "request_trace": (False, _RUNTIME),
    "request_journal_cap": (512, _RUNTIME),
    "request_sample_slow_ms": (0.0, _RUNTIME),
    "obs_http_port": (0, _RUNTIME),
    "obs_http_host": ("127.0.0.1", _RUNTIME),
    "obs_timeseries_cap": (4096, _RUNTIME),
    "health_stall_frac": (0.9, _RUNTIME),
    "health_fps_collapse": (0.5, _RUNTIME),
    "health_grad_norm_max": (0.0, _RUNTIME),
    "health_eval_drop": (0.0, _RUNTIME),
    "health_window_ttl": (3, _RUNTIME),
    "health_entropy_floor": (0.0, _RUNTIME),
    "health_staleness_max": (0.0, _RUNTIME),
    "health_rho_clip_frac": (0.0, _RUNTIME),
    "health_recompile_storm": (0, _RUNTIME),
    "health_mem_growth": (0.0, _RUNTIME),
    # No counterpart: the checker of jax's shard_map, and buffer donation
    # into a compiled step (PyTorch updates in place).
    "smap_check": ("auto", _NOTHING),
    "donate_buffers": (False, _NOTHING),
}

SUPPORTED_ENVS = ("CartPole-v1", "JaxPong-v0", "JaxPongPixels-v0", "JaxPendulum-v0")
SUPPORTED_ALGOS = ("a3c", "impala", "ppo")
FUSED_SCANS = ("auto", "kernel", "plain", "lax")
GRAD_REDUCES = ("auto", "psum", "ring")
SCAN_IMPLS = ("auto", "associative", "sequential", "kernel", "kernel_dma")


@dataclasses.dataclass(frozen=True)
class Config:
    """Training configuration for one workload (see the JAX ``Config`` for
    the meaning of each shared field)."""

    # --- workload ---
    env_id: str = "JaxPong-v0"
    algo: str = "impala"  # "a3c" | "impala" | "ppo"

    # --- rollout geometry ---
    num_envs: int = 64
    unroll_len: int = 32
    total_env_steps: int = 500_000

    # --- model ---
    torso: str = "mlp"  # "mlp" | "impala_cnn"
    hidden_sizes: tuple[int, ...] = (64, 64)
    channels: tuple[int, ...] = (16, 32, 32)

    # --- optimization (global-norm clip + Adam) ---
    learning_rate: float = 3e-4
    # "constant", or "linear": anneal from learning_rate to 0 over the run's
    # total_env_steps (learn/learner.py make_optimizer).
    lr_schedule: str = "constant"
    adam_eps: float = 1e-8
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

    # --- IMPALA / V-trace ---
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    actor_staleness: int = 1

    # --- PPO ---
    ppo_clip_eps: float = 0.2
    ppo_epochs: int = 4
    ppo_minibatches: int = 4

    # --- envs ---
    frame_skip: int = 1
    pong_opponent: str = "tracker"
    pong_opponent_speed: float = 0.0
    pong_max_steps: int = 3000

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
        if self.env_id not in SUPPORTED_ENVS:
            raise NotImplementedError(
                f"env_id={self.env_id!r} is not ported yet ({_ENVS}); "
                f"the port runs {SUPPORTED_ENVS}"
            )
        if self.algo not in SUPPORTED_ALGOS:
            raise NotImplementedError(f"algo={self.algo!r} comes with {_ALGOS}")
        if self.torso == "nature_cnn":
            raise NotImplementedError(
                "torso='nature_cnn' comes with the pixel flagship (Queue A item 8)"
            )
        if self.torso not in ("mlp", "impala_cnn"):
            raise ValueError(f"unknown torso {self.torso!r}; expected mlp|impala_cnn")
        if self.frame_skip != 1:
            raise NotImplementedError(f"frame_skip={self.frame_skip} comes with {_ENVS}")
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
            default, later = LATER_KNOBS[key]
            value = kwargs.pop(key)
            if value != default and later == _NOTHING:
                raise NotImplementedError(
                    f"{key}={value!r}: the port has no counterpart of this knob; "
                    f"only its JAX default {default!r} is accepted"
                )
            if value != default:
                raise NotImplementedError(
                    f"{key}={value!r} is not ported yet: it comes with {later}"
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
