"""The port's learner against the JAX learner, on the same fragment and the
same weights, and the port's trainer end to end on the CPU: its config
surface against the JAX ``Config``, the linear LR and the entropy anneal,
``step_cost``, fused update calls, in-training eval, the metrics sinks,
checkpoints, A3C learning CartPole, and the greedy eval of the committed
``runs/pong18_tpu`` checkpoint. RMSProp against optax; whole updates
(observation and return normalization, RMSProp, ``grad_accum``, Q-learning
with a dueling head and the Huber loss) against JAX's ``make_train_step``
body on the same fragment, which both sides take from a stand-in unroll.

The fragment comes from the JAX ``unroll`` on a narrow ``atari_impala``
(84x84x4 pixel Pong, IMPALA-CNN channels (4, 8, 8)) in f32, with behaviour
weights that differ from the learner's so the importance weights vary, and
with points, a won episode and truncations inside it.

Tolerances: the two forwards sum the same convolutions in another order, a
few f32 ulps apart; the loss and its metrics are means over the fragment
and agree to 1e-5 relative. Gradients sum over all 8 x 6 frames and every
spatial position, so they are held to 1e-4 of each tensor's largest entry.
The clip fractions count rhos against their caps and may move by one rho.
The linear schedule and the optimizer that runs it are held to optax bit
for bit (RMSProp's second moment within 4 ulps of optax's, whose global
norm sums in another order, and the weights within 1e-7 after 3 steps); the entropy anneal to JAX's eager ``entropy_coef_at`` bit for bit
and to its jitted one within 2e-9 (XLA may contract the ramp into one fused
multiply-add: an ulp of the 0.01 coefficient). A whole update against
JAX's: the loss, metrics and gradient norm 1e-5 relative, the weights
after the step 1e-6 absolute, the stats 2e-6 relative; ``grad_accum=4``
against the port's ``grad_accum=1`` within JAX's own test's bounds
(tests/test_learner.py: weights ``rtol=5e-5, atol=1e-6``, loss 1e-5).
"""

import dataclasses
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asyncrl_tpu.configs import presets as jpresets
from asyncrl_tpu.envs import registry as jregistry
from asyncrl_tpu.learn import learner as jlearner
from asyncrl_tpu.learn.learner import _algo_loss, make_optimizer as jmake_optimizer
from asyncrl_tpu.learn.learner import entropy_coef_at as jentropy_coef_at
from asyncrl_tpu.utils.config import Config as JConfig
from asyncrl_tpu.models.networks import build_model as jbuild_model
from asyncrl_tpu.ops.distributions import Categorical as JCategorical
from asyncrl_tpu.ops.normalize import init_stats as jinit_stats, update_stats as jupdate_stats
from asyncrl_tpu.rollout.anakin import actor_init as jactor_init, unroll as junroll
from asyncrl_tpu.rollout.buffer import EpisodeStats as JEpisodeStats, Rollout as JRollout
from asyncrl_tpu_torch import make_agent
from asyncrl_tpu_torch.api.trainer import Trainer, make_eval_rollout
from asyncrl_tpu_torch.config import LATER_KNOBS, Config, resolve_scan_impl
from asyncrl_tpu_torch.configs import presets as tpresets
from asyncrl_tpu_torch.envs import registry as tregistry
from asyncrl_tpu_torch.learn import learner as tlearner
from asyncrl_tpu_torch.learn.learner import (
    Learner, algo_loss, entropy_coef_at, make_optimizer, total_optimizer_steps,
)
from asyncrl_tpu_torch.models.convert import params_from_jax
from asyncrl_tpu_torch.models.networks import build_model
from asyncrl_tpu_torch.ops.distributions import Categorical
from asyncrl_tpu_torch.parallel.mesh import make_mesh
from asyncrl_tpu_torch.rollout.anakin import actor_init, unroll
from asyncrl_tpu_torch.ops.normalize import RunningStats
from asyncrl_tpu_torch.rollout.buffer import EpisodeStats, Rollout
from asyncrl_tpu_torch.utils import checkpoint as tcheckpoint
from asyncrl_tpu_torch.utils.metrics import JsonlSink, MultiSink, StdoutSink


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread for these comparisons. Its multithreaded CPU
    ``exp`` has been seen to return one worker's chunk about 1.5e-4 off on
    the first parallel call of a process that had run XLA jobs before; one
    thread computes every element the same way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T, B = 8, 6
NARROW = dict(channels=(4, 8, 8), precision="f32", num_envs=B, unroll_len=T, pong_max_steps=14)


@pytest.fixture(scope="module")
def jax_fragment():
    """(jax config, model, learner params, rollout) from the JAX unroll."""
    cfg = jpresets.atari_impala.replace(fused_scan="interpret", **NARROW)
    env = jregistry.make(cfg.env_id, cfg)
    model = jbuild_model(cfg, env.spec)
    dummy = jnp.zeros((1, *env.spec.obs_shape), jnp.uint8)
    init = jax.jit(model.init)  # op by op, the flax init takes seconds
    params = init(jax.random.PRNGKey(0), dummy)
    behaviour = init(jax.random.PRNGKey(1), dummy)
    actor = jax.jit(lambda k: jactor_init(env, B, k, model=model))(jax.random.PRNGKey(2))
    dist = JCategorical(env.spec.num_actions)
    step = jax.jit(lambda a: junroll(model.apply, behaviour, env, a, T, dist=dist)[:2])
    # After T warm-up steps (of the 14-step cap), half the balls are put one
    # step from the agent's plane, far from its paddle, and one env's rival
    # at 20 points: the fragment then holds points, an episode won at 21
    # and truncations.
    actor, _ = step(actor)
    core = actor.env_state.core
    miss = jnp.arange(B) % 2 == 0
    ball = jnp.where(miss[:, None], jnp.array([0.93, 0.2, 0.03, 0.0]), core.ball)
    agent_y = jnp.where(miss, 0.8, core.agent_y)
    score = core.score.at[0, 1].set(20)
    actor = actor.replace(env_state=actor.env_state.replace(
        core=core.replace(ball=ball, agent_y=agent_y, score=score)))
    _, rollout = step(actor)
    for flag in ("terminated", "truncated"):
        assert np.asarray(getattr(rollout, flag)).any(), flag
    assert (np.asarray(rollout.rewards) != 0).sum() >= B // 2
    return cfg, model, params, rollout


def torch_rollout(rollout) -> Rollout:
    def t(x):
        return torch.from_numpy(np.array(x))

    return Rollout(
        obs=t(rollout.obs), actions=t(rollout.actions).long(),
        behaviour_logp=t(rollout.behaviour_logp), rewards=t(rollout.rewards),
        terminated=t(rollout.terminated), truncated=t(rollout.truncated),
        bootstrap_obs=t(rollout.bootstrap_obs),
    )


def test_loss_metrics_and_grads_match_jax(jax_fragment):
    jcfg, jmodel, params, jrollout = jax_fragment
    dist = JCategorical(6)
    (_, (jloss, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda lm: (lm[0], lm))(_algo_loss(jcfg, jmodel.apply, p, jrollout, dist=dist)),
        has_aux=True,
    ))(params)

    tcfg = tpresets.atari_impala.replace(device="cpu", **NARROW)
    spec = tregistry.make(tcfg.env_id, tcfg).spec
    tmodel = params_from_jax(jax.device_get(params), build_model(tcfg, spec, torch.Generator()))
    loss, metrics = algo_loss(tcfg, tmodel, torch_rollout(jrollout), Categorical(6))
    grads = torch.autograd.grad(loss, list(tmodel.parameters()))

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        if k.endswith("clip_frac"):
            assert abs(float(metrics[k]) - float(v)) <= 1.0 / (T * B), k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    # The JAX gradient tree has the params' layout: load it like params.
    jgrad_model = params_from_jax(jax.device_get(jgrads), build_model(tcfg, spec, torch.Generator()))
    for (name, jg), g in zip(jgrad_model.named_parameters(), grads):
        jg = jg.detach().numpy()
        np.testing.assert_allclose(
            g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max() + 1e-12, err_msg=name
        )


@pytest.mark.parametrize("scale", [0.01, 3.0])  # below and above max_grad_norm
def test_clip_adam_matches_optax(scale):
    cfg = tpresets.pong_impala.replace(device="cpu")
    rng = np.random.default_rng(int(scale * 100))
    shapes = [(5, 3), (3,), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = jmake_optimizer(jpresets.pong_impala)
    jparams, jstate = list(params), opt.init(params)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(cfg)
    tstate = topt.init(tparams)
    for _ in range(3):
        grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = topt.step(tparams, [torch.from_numpy(g) for g in grads], tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6, atol=1e-8)


@pytest.mark.parametrize("scale", [0.01, 3.0])  # below and above max_grad_norm
def test_clip_rmsprop_matches_optax(scale):
    """optax.chain(clip_by_global_norm, rmsprop(decay=0.99, eps=0.1)) over
    three steps: eps inside the square root, the second moment from 0."""
    jcfg = jpresets.pong_impala.replace(optimizer="rmsprop")
    cfg = tpresets.pong_impala.replace(device="cpu", optimizer="rmsprop")
    rng = np.random.default_rng(int(scale * 100) + 1)
    shapes = [(5, 3), (3,), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = jmake_optimizer(jcfg)
    jparams, jstate = list(params), opt.init(params)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(cfg)
    assert isinstance(topt, tlearner.ClipRMSProp)
    tstate = topt.init(tparams)
    for _ in range(3):
        grads = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = topt.step(tparams, [torch.from_numpy(g) for g in grads], tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        # Past the clip the gradients are g / norm * max_norm, and the norm
        # sums the squares in another order than optax: an ulp or two, and
        # a few in the squared moment.
        for nu, jnu in zip(tstate.nu, jstate[1][0].nu):
            np.testing.assert_array_max_ulp(nu.numpy(), np.asarray(jnu), maxulp=4)
        for t, j in zip(tparams, jparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)
    assert tstate.count == 3
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(cfg.replace(optimizer="sgd"))


def test_unroll_records_a_consistent_fragment():
    cfg = tpresets.pong_impala.replace(device="cpu", pong_max_steps=10)
    env = tregistry.make(cfg.env_id, cfg)
    model = build_model(cfg, env.spec, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    actor = actor_init(env, 5, gen, "cpu")
    first_obs = actor.obs.clone()
    dist = Categorical(6)
    actor, rollout, stats = unroll(model, env, actor, 12, gen, dist, reward_scale=0.5)
    assert torch.equal(rollout.obs[0], first_obs)
    assert torch.equal(rollout.bootstrap_obs, actor.obs)
    with torch.no_grad():
        logits, _ = model(rollout.obs)
    assert torch.allclose(rollout.behaviour_logp, dist.logp(logits, rollout.actions))
    # Every env truncates at step 10 of 12.
    assert float(stats.completed_count) == float(rollout.done.sum()) == 5
    assert float(stats.completed_length_sum) == 50
    assert torch.all(actor.running_length == 2)


def test_make_agent_trains_two_windows_on_cpu():
    agent = make_agent(
        tpresets.pong_impala, device="cpu", num_envs=8, unroll_len=4, log_every=2,
        hidden_sizes=(32, 32),
    )
    before = [p.clone() for p in agent.state.params.parameters()]
    history = agent.train(total_env_steps=4 * 8 * 4)
    assert len(history) == 2 and agent.state.update_step == 4
    for window in history:
        assert all(np.isfinite(v) for v in window.values()), window
        assert window["fps"] > 0
    after = list(agent.state.params.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    # actor_staleness=2: the actor weights were refreshed at update 4.
    for a, p in zip(agent.state.actor_params.parameters(), after):
        assert torch.equal(a, p)
    assert np.isfinite(agent.evaluate(num_episodes=3, max_steps=30))


NEW_PRESETS = (
    "breakout_impala", "hopper_ppo", "walker_ppo", "halfcheetah_ppo", "brax_ant_ppo",
    "brax_humanoid_ppo", "pong_t2t_1024", "pong_t2t_ale", "pong_t2t_ale4", "pong_pixels_t2t",
)


@pytest.mark.parametrize("name", [
    "pong_impala", "atari_impala", "brax_ppo", "cartpole_a3c", "cartpole_impala", "cartpole_ppo",
    "pong_t2t", "procgen_ppo", "cartpole_qlearn", "pong_qlearn", "atari_impala_wide",
    "pong_selfplay", *NEW_PRESETS, "pendulum_native_ppo", "cartpole_a3c_cpu", "pong_serve",
    "mujoco_ant_ppo", "mujoco_humanoid_ppo",
])
def test_presets_copy_the_jax_presets(name):
    """Every field the port shares with the JAX Config has the JAX
    preset's value (and the JAX default where the preset sets none)."""
    ported, ref = getattr(tpresets, name), getattr(jpresets, name)
    shared = [f.name for f in dataclasses.fields(ported) if hasattr(ref, f.name)]
    assert len(shared) >= 25
    for field in shared:
        assert getattr(ported, field) == getattr(ref, field), field


def test_config_refuses_what_is_not_ported():
    cfg = tpresets.pong_impala
    assert cfg.replace(core="ff", backend="tpu") == cfg  # JAX defaults: accepted
    # The gymnasium envs run on the host path only; the MinAtar games are
    # ported.
    for knob in ({"env_id": "Ant-v5"}, {"algo": "ddpg"}):
        with pytest.raises(NotImplementedError):
            cfg.replace(**knob)
    # The divergence rollback's knobs are fields now, accepted off their
    # defaults (the Anakin trainer ignores them, as JAX's does).
    assert cfg.replace(rollback_bad_windows=2, rollback_max_attempts=3).rollback_bad_windows == 2
    assert cfg.replace(backend="sebulba", env_id="Ant-v5").env_id == "Ant-v5"
    assert cfg.replace(env_id="JaxSpaceInvaders-v0").env_id == "JaxSpaceInvaders-v0"
    with pytest.raises(ValueError, match="nature_cnn"):
        cfg.replace(torso="nature_dqn")
    # Ported knobs are fields now, accepted off their JAX defaults.
    ported = dict(optimizer="rmsprop", normalize_obs=True, normalize_returns=True, grad_accum=2,
                  remat=True, algo="qlearn", dueling=True, double_q=False, huber_delta=1.0,
                  core="lstm", core_size=128, selfplay=True, selfplay_refresh=50,
                  frame_skip=4, frame_pool=True, sticky_actions=0.25, torso="nature_cnn",
                  env_id="JaxBreakout-v0", inference_server=True, serve=False, replay_slabs=4,
                  replay_passes=3, target_update_period=10, replay_rho_clip=1.5,
                  serve_deadline_ms=5.0, serve_slo_p95_ms=50.0, serve_max_inflight=8,
                  serve_shed=True, gateway_port=-1, gateway_host="0.0.0.0",
                  gateway_deadline_ms=500.0, gateway_tenant_spec="gold:stale",
                  fault_spec="serve.swap:crash:1.0:0", stall_timeout_s=4.0, trace=True,
                  trace_ring=512, trace_window_s=5.0, run_dir="runs/x", request_trace=True,
                  request_journal_cap=64, request_sample_slow_ms=10.0, resume=True)
    assert all(getattr(cfg.replace(**ported), k) == v for k, v in ported.items())
    with pytest.raises(KeyError):
        cfg.replace(no_such_knob=1)
    with pytest.raises(ValueError):
        cfg.replace(fused_scan="interpret")
    # The mesh knobs are fields now; grad_reduce resolves as the JAX learner's.
    assert cfg.replace(mesh_shape=(8,), mesh_axes=("dp",), grad_reduce="ring").mesh_shape == (8,)
    one_rank = make_mesh((1,), devices=["cpu"])
    assert resolve_scan_impl(cfg, one_rank).grad_reduce == "psum"
    assert resolve_scan_impl(cfg.replace(grad_reduce="ring"), one_rank).grad_reduce == "ring"
    with pytest.raises(ValueError):
        resolve_scan_impl(cfg.replace(grad_reduce="allreduce"), one_rank)
    with pytest.raises(ValueError):
        resolve_scan_impl(cfg.replace(grad_reduce="ring"),
                          make_mesh((1, 1), ("dcn", "dp"), devices=["cpu"]))
    with pytest.raises(NotImplementedError):
        make_mesh((2,), devices=["cuda:0", "cuda:1"])


def off_default(value):
    """A value of the same type as ``value`` that differs from it."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    return str(value) + "_other"


def test_config_accepts_every_jax_knob_at_its_default():
    """Every field of the JAX Config is a field of the port's or one of its
    LATER_KNOBS, with the JAX default; at that default replace() leaves the
    config as it was, and off it raises NotImplementedError saying that it
    has no counterpart."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    missing = {k: v for k, v in jax_fields.items() if k not in ours}
    assert set(missing) == set(LATER_KNOBS)
    for name, default in LATER_KNOBS.items():
        assert default == missing[name], name
    # Shared fields keep the JAX default but for the workload's own two.
    for name in set(ours) & set(jax_fields):
        if name not in ("env_id", "algo"):
            assert ours[name] == jax_fields[name], name
    cfg = tpresets.pong_impala
    assert cfg.replace(**missing) == cfg
    for name, default in missing.items():
        assert cfg.replace(**{name: default}) == cfg, name
        with pytest.raises(NotImplementedError, match="Queue A item|no counterpart"):
            cfg.replace(**{name: off_default(default)})
    agent = make_agent(tpresets.pong_impala, device="cpu", eval_episodes=32, smap_check="auto",
                       trace=False, serve=True)
    assert agent.config.eval_episodes == 32


def test_linear_schedule_and_optimizer_match_optax():
    """lr_schedule="linear": optax.linear_schedule(lr, 0, total optimizer
    steps), evaluated at the count before each step, and the clip + Adam
    step that uses it, bit for bit over 13 steps, 3 past the horizon."""
    horizon = 10
    jcfg = jpresets.pong_impala.replace(lr_schedule="linear", total_env_steps=8192 * horizon)
    cfg = tpresets.pong_impala.replace(device="cpu", lr_schedule="linear",
                                       total_env_steps=8192 * horizon)
    assert total_optimizer_steps(cfg) == horizon
    ppo = tpresets.brax_ppo.replace(device="cpu", lr_schedule="linear")
    assert total_optimizer_steps(ppo) == 10_000_000 // (8192 * 64) * 4 * 8
    schedule = optax.linear_schedule(cfg.learning_rate, 0.0, horizon)
    rng = np.random.default_rng(5)
    shapes = [(5, 3), (3,), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = jmake_optimizer(jcfg)
    jparams, jstate = list(params), opt.init(params)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    topt = make_optimizer(cfg)
    tstate = topt.init(tparams)
    for k in range(horizon + 3):
        assert np.float32(topt.rate(k)) == np.asarray(schedule(k)), k
        grads = [(rng.choice([0.01, 3.0]) * rng.standard_normal(s)).astype(np.float32)
                 for s in shapes]
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step(tparams, [torch.from_numpy(g) for g in grads], tstate)
        for t, j in zip(tparams, jparams):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"step {k}")
    assert topt.rate(horizon) == 0.0
    with pytest.raises(ValueError, match="lr_schedule"):
        make_optimizer(cfg.replace(lr_schedule="cosine"))
    # Training past the horizon of an annealed rate is refused, as in JAX.
    agent = make_agent(tpresets.cartpole_a3c, device="cpu", lr_schedule="linear",
                       num_envs=4, unroll_len=4, total_env_steps=64)
    with pytest.raises(ValueError, match="horizon"):
        agent.train(total_env_steps=128)


def test_entropy_coef_at_matches_jax():
    cfg = tpresets.pong_t2t.replace(device="cpu")
    jcfg = jpresets.pong_t2t
    assert entropy_coef_at(cfg.replace(entropy_anneal_steps=0), 123) == cfg.entropy_coef
    steps = np.arange(0, 31_000, 97).astype(np.int32)
    jitted = np.asarray(jax.jit(jax.vmap(lambda s: jentropy_coef_at(jcfg, s)))(steps))
    for step, j in zip(steps[::8], jitted[::8]):
        ours = entropy_coef_at(cfg, int(step))
        assert ours == float(jentropy_coef_at(jcfg, jnp.int32(step))), step
        assert abs(ours - float(j)) <= 2e-9, step
    # Held after the ramp, at the f32 sum that ends it (not f32(1e-4)).
    end = float(jentropy_coef_at(jcfg, jnp.int32(40_000)))
    assert entropy_coef_at(cfg, 30_000) == entropy_coef_at(cfg, 40_000) == end
    assert abs(end - 1e-4) < 1e-9


@pytest.mark.parametrize("algo,epochs", [("a3c", 1), ("impala", 1), ("ppo", 1), ("ppo", 2)])
def test_every_loss_takes_the_annealed_entropy_coef(monkeypatch, algo, epochs):
    """Each update's loss (every minibatch step of multipass PPO) uses
    entropy_coef_at(config, update_step)."""
    seen = []
    for name in ("a3c_loss", "impala_loss", "ppo_loss"):
        def spy(*args, _loss=getattr(tlearner, name), **kw):
            seen.append(kw["entropy_coef"])
            return _loss(*args, **kw)
        monkeypatch.setattr(tlearner, name, spy)
    cfg = tpresets.cartpole_a3c.replace(
        device="cpu", algo=algo, num_envs=4, unroll_len=4, entropy_anneal_steps=4,
        entropy_coef_final=0.001, ppo_epochs=epochs, ppo_minibatches=epochs,
    )
    agent = make_agent(cfg)
    for step in range(3):
        before = len(seen)
        agent.state, _ = agent.learner.update(agent.state)
        assert seen[before:] == [entropy_coef_at(cfg, step)] * (epochs * epochs), step
    assert len(set(seen)) == 3


def test_step_cost_shapes_the_learner_view_only():
    """The learner's rewards are (r - step_cost) * reward_scale; the
    trajectory and the episode sums are those of the raw run (JAX's
    test_step_cost_shapes_learner_view_only)."""
    cfg = tpresets.cartpole_a3c.replace(device="cpu")
    env = tregistry.make(cfg.env_id, cfg)
    model = build_model(cfg, env.spec, torch.Generator().manual_seed(0))
    runs = []
    for step_cost, scale in ((0.0, 1.0), (0.01, 2.0)):
        gen = torch.Generator().manual_seed(1)
        actor = actor_init(env, 16, gen, "cpu")
        runs.append(unroll(model, env, actor, 48, gen, Categorical(2), reward_scale=scale,
                           step_cost=step_cost))
    (_, raw, raw_stats), (_, cost, cost_stats) = runs
    assert torch.equal(raw.obs, cost.obs) and torch.equal(raw.actions, cost.actions)
    assert torch.equal(cost.rewards, (raw.rewards - 0.01) * 2.0)
    assert float(raw_stats.completed_count) > 0
    for f in ("completed_return_sum", "completed_length_sum", "completed_count"):
        assert torch.equal(getattr(raw_stats, f), getattr(cost_stats, f)), f


def tiny(preset="cartpole_a3c", **kw):
    base = dict(device="cpu", num_envs=8, unroll_len=8, precision="f32", log_every=2)
    base.update(kw)
    return getattr(tpresets, preset).replace(**base)


def states_equal(a, b) -> bool:
    fa, fb = tcheckpoint.state_dict(a), tcheckpoint.state_dict(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor) else fa[k] == fb[k]
        for k in fa
    )


@pytest.mark.parametrize("preset", ["cartpole_a3c", "cartpole_impala", "cartpole_ppo"])
def test_updates_per_call_equals_single_updates(preset):
    """One call of 3 fused updates = 3 calls of one, bit for bit: the state
    and each metric, stacked [3]."""
    fused = Trainer(tiny(preset, updates_per_call=3, entropy_anneal_steps=5))
    single = Trainer(tiny(preset, entropy_anneal_steps=5))
    fused.state, stacked = fused.learner.update(fused.state)
    steps = []
    for _ in range(3):
        single.state, m = single.learner.update(single.state)
        steps.append(m)
    assert fused.state.update_step == single.state.update_step == 3
    assert states_equal(fused.state, single.state)
    assert set(stacked) == set(steps[0])
    for k, v in stacked.items():
        assert v.shape == (3,), k
        assert torch.equal(v, torch.stack([m[k] for m in steps])), k


def test_train_windows_average_fused_calls_and_count_env_steps():
    agent = make_agent(tiny(updates_per_call=3, log_every=2))
    history = agent.train(total_env_steps=8 * 8 * 3 * 4)
    assert len(history) == 2 and agent.state.update_step == 12
    assert [w["env_steps"] for w in history] == [8 * 8 * 3 * 2, 8 * 8 * 3 * 4]
    for window in history:
        assert all(math.isfinite(v) for v in window.values()), window


def test_in_training_eval_cadence():
    """eval_every=4 calls with log_every=2 over 12 calls: evals on windows
    2, 4 and 6 (JAX's tests/test_api.py::test_in_training_eval_cadence)."""
    agent = make_agent(tiny(log_every=2, eval_every=4, eval_episodes=4))
    history = agent.train(total_env_steps=8 * 8 * 12)
    with_eval = [i for i, h in enumerate(history) if "eval_return" in h]
    assert with_eval == [1, 3, 5], (with_eval, len(history))
    assert all(math.isfinite(history[i]["eval_return"]) for i in with_eval)


def test_metrics_sinks_write_the_windows(tmp_path):
    path = tmp_path / "metrics.jsonl"
    stream = io.StringIO()
    sink = MultiSink(StdoutSink(stream=stream), JsonlSink(str(path)), None)
    agent = make_agent(tiny(log_every=2, eval_every=2, eval_episodes=2))
    with sink:
        history = agent.train(total_env_steps=8 * 8 * 4, callback=sink)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == history and len(lines) == 2
    printed = stream.getvalue().splitlines()
    assert len(printed) == 2 and all("steps=" in p and "eval_return=" in p for p in printed)
    as_json = io.StringIO()
    StdoutSink(as_json=True, stream=as_json).write(history[0])
    assert json.loads(as_json.getvalue()) == history[0]
    bare = io.StringIO()
    StdoutSink(stream=bare).write({"loss": 1.5})
    assert bare.getvalue().strip() == "loss=  1.5000"  # absent keys are left out


@pytest.mark.parametrize("preset", ["cartpole_impala", "cartpole_a3c"])
def test_checkpoint_restore_gives_a_bit_exact_next_update(tmp_path, preset):
    """JAX's tests/test_checkpoint.py::test_save_restore_bit_exact_next_step:
    after a save and a restore into a fresh trainer, the next update equals
    the next update of the run that did not stop, state and metrics."""
    cfg = tiny(preset)
    t = Trainer(cfg)
    for _ in range(3):
        t.state, _ = t.learner.update(t.state)
    t.env_steps = 3 * cfg.batch_steps_per_update
    ck = tcheckpoint.Checkpointer(str(tmp_path / "ck"))
    ck.save(t.state.update_step, t.state, t.env_steps)
    ck.wait()  # the writer runs off this thread
    assert ck.all_steps() == [3] and ck.read_manifest(3)["env_steps"] == t.env_steps
    fresh = Trainer(cfg)
    assert not states_equal(fresh.state, t.state)
    assert ck.restore(fresh.state) == t.env_steps
    assert states_equal(fresh.state, t.state)
    cont_state, cont_metrics = t.learner.update(t.state)
    res_state, res_metrics = fresh.learner.update(fresh.state)
    assert states_equal(cont_state, res_state)
    for k in cont_metrics:
        assert torch.equal(cont_metrics[k], res_metrics[k]), k


def test_trainer_checkpoints_and_auto_resumes(tmp_path):
    ck_dir = str(tmp_path / "auto")
    cfg = tiny("cartpole_impala", checkpoint_dir=ck_dir, checkpoint_every=2)
    t = Trainer(cfg)
    t.train(total_env_steps=5 * cfg.batch_steps_per_update)
    assert t.checkpointer.all_steps() == [2, 4, 5]  # every 2 calls, and at exit
    t2 = Trainer(cfg)  # the same directory: resume from its latest step
    assert t2.state.update_step == 5 and t2.env_steps == 5 * cfg.batch_steps_per_update
    assert states_equal(t2.state, t.state)
    t2.save_checkpoint()  # the step it restored: nothing to write
    with pytest.raises(ValueError, match="state-structure"):
        Trainer(cfg.replace(num_envs=16))
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        Trainer(tiny()).save_checkpoint()


def test_corrupted_checkpoint_raises_checksum_mismatch(tmp_path):
    cfg = tiny()
    t = Trainer(cfg)
    t.state, _ = t.learner.update(t.state)
    ck = tcheckpoint.Checkpointer(str(tmp_path / "ck"))
    ck.save(1, t.state, 64)
    ck.wait()
    path = os.path.join(ck.directory, "1", tcheckpoint.STATE_FILE)
    flat = torch.load(path, weights_only=True)
    flat["opt.mu.0"] = flat["opt.mu.0"] + 1.0  # a well-formed file, other content
    torch.save(flat, path)
    with pytest.raises(tcheckpoint.ChecksumMismatch):
        ck.restore(Trainer(cfg).state)


def test_restore_is_read_only_and_refuses_an_empty_path(tmp_path):
    src = str(tmp_path / "src")
    cfg = tiny(checkpoint_dir=src)
    t = Trainer(cfg)
    t.train(total_env_steps=2 * cfg.batch_steps_per_update)
    listing = sorted((p, os.path.getmtime(os.path.join(d, p)))
                     for d, _, files in os.walk(src) for p in files)
    agent = make_agent(tiny(), restore=src)
    assert agent.state.update_step == 2 and states_equal(agent.state, t.state)
    agent.train(total_env_steps=4 * cfg.batch_steps_per_update)
    after = sorted((p, os.path.getmtime(os.path.join(d, p)))
                   for d, _, files in os.walk(src) for p in files)
    assert after == listing
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        make_agent(tiny(), restore=str(empty))
    with pytest.raises(FileNotFoundError):
        make_agent(tiny(), restore=str(tmp_path / "missing"))
    assert not (tmp_path / "missing").exists()
    with pytest.raises(ValueError, match="state-structure"):
        make_agent(tiny(algo="impala"), restore=src)


def test_checkpoint_best_keeps_the_best_eval(tmp_path):
    ck_dir = str(tmp_path / "run")
    with pytest.raises(ValueError, match="checkpoint_best"):
        Trainer(tiny(checkpoint_dir=ck_dir, checkpoint_best=True))
    cfg = tiny(checkpoint_dir=ck_dir, checkpoint_best=True, eval_every=1, eval_episodes=2)
    history = Trainer(cfg).train(total_env_steps=4 * cfg.batch_steps_per_update)
    evals = [w["eval_return"] for w in history]
    best = tcheckpoint.Checkpointer(ck_dir + "-best", create=False)
    assert len(best.all_steps()) == 1
    assert best.read_meta()["eval_return"] == max(evals)


# Presets too wide for the CPU train here narrowed (their full width runs on
# the card in chip_smoke.py): procgen_ppo at 16 envs, T=8, IMPALA-CNN (4, 8, 8);
# atari_impala_wide at 8 envs (2 a grad_accum chunk), T=4, (4, 8, 8), remat on.
NARROW_ON_CPU = {
    "breakout_impala": dict(num_envs=16, unroll_len=8),
    "procgen_ppo": dict(num_envs=16, unroll_len=8, channels=(4, 8, 8)),
    "atari_impala_wide": dict(num_envs=8, unroll_len=4, channels=(4, 8, 8)),
}


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_new_presets_build_on_cpu(name):
    """Every preset this port copies builds a trainer at its full width on
    the CPU: env, model, learner and the initial state."""
    agent = make_agent(getattr(tpresets, name), device="cpu")
    preset = getattr(tpresets, name)
    assert agent.state.actor.obs.shape[0] == preset.num_envs
    assert agent.env.spec.obs_shape == tregistry.make(preset.env_id, preset).spec.obs_shape


@pytest.mark.parametrize("name", [
    "cartpole_a3c", "cartpole_impala", "cartpole_ppo", "pong_t2t", "procgen_ppo",
    "atari_impala_wide", "breakout_impala",
])
def test_presets_train_on_cpu(name):
    preset = getattr(tpresets, name).replace(**NARROW_ON_CPU.get(name, {}))
    agent = make_agent(preset, device="cpu", log_every=1, eval_every=0)
    calls = 2
    history = agent.train(
        total_env_steps=calls * preset.batch_steps_per_update * preset.updates_per_call)
    assert agent.state.update_step == calls * preset.updates_per_call
    assert len(history) == calls
    for window in history:
        assert all(math.isfinite(v) for v in window.values()), window
        assert 0.0 < window["entropy"] <= math.log(agent.env.spec.num_actions) + 1e-4, window


def test_checkpoint_round_trip_keeps_rmsprop_state_and_stats(tmp_path):
    """RMSProp's layout (``opt.nu`` alone) and the observation and return
    stats ride the checkpoint; the next update after a restore is the
    uninterrupted run's; resuming with normalization switched is refused."""
    cfg = tiny("cartpole_impala", optimizer="rmsprop", normalize_obs=True,
               normalize_returns=True, checkpoint_dir=str(tmp_path / "ck"))
    t = Trainer(cfg)
    for _ in range(3):
        t.state, _ = t.learner.update(t.state)
    flat = tcheckpoint.state_dict(t.state)
    assert any(k.startswith("opt.nu.") for k in flat)
    assert not any(k.startswith("opt.mu.") for k in flat)
    for k in ("obs_stats.count", "obs_stats.mean", "obs_stats.m2", "ret_stats.m2",
              "actor.disc_return"):
        assert isinstance(flat[k], torch.Tensor), k
    t.save_checkpoint()
    t.checkpointer.wait()
    resumed = Trainer(cfg)
    assert states_equal(resumed.state, t.state)
    assert isinstance(resumed.state.obs_stats, RunningStats)
    a, am = t.learner.update(t.state)
    b, bm = resumed.learner.update(resumed.state)
    assert states_equal(a, b)
    assert all(torch.equal(am[k], bm[k]) for k in am)
    for change in ({"normalize_obs": False}, {"optimizer": "adam"}, {"normalize_returns": False}):
        with pytest.raises(ValueError, match="state-structure"):
            Trainer(cfg.replace(**change))


# --- whole updates against JAX's make_train_step body, on one fragment ---

UT, UB = 8, 16


def update_fragment(seed: int = 0, obs_scale: float = 3.0) -> dict[str, np.ndarray]:
    """A CartPole-shaped fragment (with its discounted-return stream) made
    with numpy, observations off zero mean and unit scale."""
    rng = np.random.default_rng(seed)
    return {
        "obs": (obs_scale * rng.normal(size=(UT, UB, 4)) + 1.5).astype(np.float32),
        "actions": rng.integers(0, 2, (UT, UB)).astype(np.int32),
        "behaviour_logp": rng.normal(-0.7, 0.05, (UT, UB)).astype(np.float32),
        "rewards": rng.normal(size=(UT, UB)).astype(np.float32),
        "terminated": rng.uniform(size=(UT, UB)) < 0.1,
        "truncated": rng.uniform(size=(UT, UB)) < 0.05,
        "bootstrap_obs": (obs_scale * rng.normal(size=(UB, 4)) + 1.5).astype(np.float32),
        "disc_returns": rng.normal(0.0, 4.0, (UT, UB)).astype(np.float32),
    }


def jax_update(monkeypatch, jcfg, frag, update_step: int):
    """One update of JAX's train-step body (no mesh axes) from two inits of
    the model (online and behaviour/target) and stats that have folded one
    batch, with its unroll replaced by one that returns ``frag``. Returns
    the state before and after, and the metrics."""
    env = jregistry.make(jcfg.env_id, jcfg)
    model = jbuild_model(jcfg, env.spec)
    init = jax.jit(model.init)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    actor_params = init(jax.random.PRNGKey(1), jnp.zeros((1, 4)))
    actor = jax.jit(lambda k: jactor_init(env, UB, k, track_returns=jcfg.normalize_returns))(
        jax.random.PRNGKey(2))
    rng = np.random.default_rng(9)
    obs_stats = jupdate_stats(jinit_stats((4,)), jnp.asarray(
        (2.0 * rng.normal(size=(5, 4)) + 1.0).astype(np.float32))) if jcfg.normalize_obs else None
    ret_stats = jupdate_stats(jinit_stats(()), jnp.asarray(
        rng.normal(0.0, 3.0, 20).astype(np.float32))) if jcfg.normalize_returns else None
    rollout = JRollout(**{k: jnp.asarray(v) for k, v in frag.items()
                          if k != "disc_returns" or jcfg.normalize_returns})
    zero = jnp.zeros(())

    def fake_unroll(apply_fn, params, env, actor_state, *args, **kwargs):
        return actor_state, rollout, JEpisodeStats(zero, zero, zero)

    monkeypatch.setattr(jlearner, "unroll", fake_unroll)
    optimizer = jlearner.make_optimizer(jcfg)
    before = jlearner.TrainState(
        params=params, actor_params=actor_params, opt_state=optimizer.init(params), actor=actor,
        update_step=jnp.int32(update_step), obs_stats=obs_stats, ret_stats=ret_stats,
    )
    body = jlearner.make_train_step(jcfg, env, model.apply, optimizer, None, axes=())
    after, metrics = jax.jit(body)(before)
    return jax.device_get(before), jax.device_get(after), jax.device_get(metrics)


def port_update(monkeypatch, cfg, frag, before):
    """The port's update from JAX's state ``before`` on ``frag``."""
    env = tregistry.make(cfg.env_id, cfg)
    learner = Learner(cfg, env, build_model(cfg, env.spec, torch.Generator()))
    state = learner.init_state(0)
    params_from_jax(before.params, state.params)
    if state.actor_params is not state.params:
        params_from_jax(before.actor_params, state.actor_params)
    state.update_step = int(before.update_step)

    def stats(s):
        return None if s is None else RunningStats(*(torch.from_numpy(np.array(x)) for x in s))

    state.obs_stats, state.ret_stats = stats(before.obs_stats), stats(before.ret_stats)
    t = {k: torch.from_numpy(np.array(v)) for k, v in frag.items()}
    t["actions"] = t["actions"].long()
    if not cfg.normalize_returns:
        t.pop("disc_returns")
    zero = torch.zeros(())

    def fake_unroll(model, env, actor, *args, **kwargs):
        return actor, Rollout(**t), EpisodeStats(zero, zero, zero)

    monkeypatch.setattr(tlearner, "unroll", fake_unroll)
    return learner.update_once(state)


def assert_update_matches(state, metrics, jafter, jmetrics, cfg, spec, atol=1e-6):
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    new = params_from_jax(jafter.params, build_model(cfg, spec, torch.Generator()))
    for (name, j), p in zip(new.named_parameters(), state.params.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), j.detach().numpy(), rtol=0, atol=atol,
                                   err_msg=name)
    for name in ("obs_stats", "ret_stats"):
        ours, ref = getattr(state, name), getattr(jafter, name)
        assert (ours is None) == (ref is None), name
        if ours is not None:
            for a, b in zip(ours, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, err_msg=name)


UPDATE_CASES = {
    # A3C behind both stats, on RMSProp.
    "a3c_normalized_rmsprop": ("cartpole_a3c", dict(
        normalize_obs=True, normalize_returns=True, optimizer="rmsprop"), 0),
    # IMPALA on 4 chunks of 4 envs, the behaviour copy refreshed.
    "impala_grad_accum4": ("cartpole_impala", dict(grad_accum=4), 1),
    # Q-learning behind the obs stats (the target's forward too), dueling,
    # Huber, max-Q, 2 chunks, the target refreshed.
    "qlearn_dueling_huber_normalized": ("cartpole_qlearn", dict(
        normalize_obs=True, dueling=True, huber_delta=1.0, double_q=False, grad_accum=2), 3),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax_train_step(monkeypatch, case):
    name, knobs, step = UPDATE_CASES[case]
    frag = update_fragment()
    small = dict(num_envs=UB, unroll_len=UT, precision="f32", hidden_sizes=(32, 32))
    jcfg = getattr(jpresets, name).replace(fused_scan="interpret", **small, **knobs)
    cfg = getattr(tpresets, name).replace(device="cpu", **small, **knobs)
    before, jafter, jmetrics = jax_update(monkeypatch, jcfg, frag, step)
    state, metrics = port_update(monkeypatch, cfg, frag, before)
    assert state.update_step == int(jafter.update_step) == step + 1
    spec = tregistry.make(cfg.env_id, cfg).spec
    assert_update_matches(state, metrics, jafter, jmetrics, cfg, spec)
    if cfg.actor_staleness > 1:  # both refresh at this step
        assert (step + 1) % cfg.actor_staleness == 0
        for a, p in zip(state.actor_params.parameters(), state.params.parameters()):
            assert torch.equal(a, p)


def test_grad_accum_4_is_the_full_batch_update(monkeypatch):
    """The port's grad_accum=4 against its grad_accum=1 on one fragment, as
    JAX's test_grad_accum_matches_full_batch holds its own two."""
    frag = update_fragment(seed=1)
    small = dict(num_envs=UB, unroll_len=UT, precision="f32", hidden_sizes=(32, 32))
    jcfg = jpresets.cartpole_impala.replace(fused_scan="interpret", **small)
    before, _, _ = jax_update(monkeypatch, jcfg, frag, 0)
    runs = {}
    for n in (1, 4):
        cfg = tpresets.cartpole_impala.replace(device="cpu", grad_accum=n, **small)
        runs[n] = port_update(monkeypatch, cfg, frag, before)
    (full, full_m), (acc, acc_m) = runs[1], runs[4]
    np.testing.assert_allclose(float(acc_m["loss"]), float(full_m["loss"]), rtol=1e-5)
    for a, b in zip(acc.params.parameters(), full.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("case", [
    ("grad_accum not dividing the envs", dict(grad_accum=3), "must divide"),
    ("grad_accum with multipass PPO", dict(algo="ppo", grad_accum=2, ppo_epochs=2),
     "ppo_minibatches"),
    ("grad_accum with single-pass PPO", dict(algo="ppo", grad_accum=2, ppo_epochs=1,
                                             ppo_minibatches=1), "ppo_minibatches"),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_grad_accum_refusals(case):
    _, knobs, match = case
    with pytest.raises(ValueError, match=match):
        make_agent(tiny("cartpole_impala", num_envs=8, **knobs))


def test_a3c_learns_cartpole_on_cpu():
    """JAX's tests/test_api.py::test_train_smoke_learns_a_bit on the port:
    120k frames of A3C beat the ~22-step random CartPole policy by a wide
    margin. The last window's return at seeds 0-4 was 165.2, 171.7, 137.2,
    143.4 and 95.4 (about 15 s each on one CPU thread)."""
    agent = make_agent(
        device="cpu", env_id="CartPole-v1", algo="a3c", num_envs=16, unroll_len=16,
        learning_rate=3e-3, precision="f32", total_env_steps=120_000, log_every=50, seed=0,
    )
    history = agent.train()
    assert history[-1]["episode_return"] > 80, history[-1]


# The ledger's eval_cap rows of runs/pong18_tpu (BENCH_HISTORY.json, preset
# pong_t2t, 64 greedy episodes each, JAX on the CPU): cap -> (mean, std).
PONG18_EVAL_CAPS = {3000: (15.594, 3.024), 27_000: (20.172, 0.821)}


@pytest.fixture(scope="module")
def pong18_params():
    """The committed checkpoint's latest step, restored read-only through
    the JAX package as scripts/eval_caps.py does."""
    from asyncrl_tpu.api.factory import make_agent as jmake_agent

    trainer = jmake_agent(jpresets.pong_t2t.replace(checkpoint_dir="", checkpoint_best=False),
                          restore="runs/pong18_tpu")
    try:
        return jax.device_get(trainer.state.params)
    finally:
        trainer.close()


@pytest.mark.parametrize("cap", sorted(PONG18_EVAL_CAPS))
def test_pong18_checkpoint_plays_as_in_the_ledger(pong18_params, cap):
    """The runs/pong18_tpu weights, converted with params_from_jax, play 64
    greedy episodes of the port's Pong (max_steps = cap + 200, as
    scripts/eval_caps.py). The two packages draw serves from different
    generators, so the bar is statistical: the mean is held within 4·√2
    standard errors of the ledger's 64-episode mean (both samples' errors),
    [13.45, 17.73] at cap 3,000 and [19.59, 20.75] at 27,000."""
    mean, std = PONG18_EVAL_CAPS[cap]
    half_band = 4 * math.sqrt(2) * std / math.sqrt(64)
    cfg = tpresets.pong_t2t.replace(device="cpu", pong_max_steps=cap)
    env = tregistry.make(cfg.env_id, cfg)
    model = params_from_jax(pong18_params, build_model(cfg, env.spec, torch.Generator()))
    returns = make_eval_rollout(env, model, 64, cap + 200)(torch.Generator().manual_seed(1234))
    assert returns.shape == (64,)
    assert abs(float(returns.mean()) - mean) <= half_band, (float(returns.mean()), mean, half_band)
