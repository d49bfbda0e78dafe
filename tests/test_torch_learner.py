"""The port's learner against the JAX learner, on the same fragment and the
same weights, and the port's trainer end to end on the CPU: its config
surface against the JAX ``Config``, the linear LR and the entropy anneal,
``step_cost``, fused update calls, in-training eval, the metrics sinks,
checkpoints, A3C learning CartPole, and the greedy eval of the committed
``runs/pong18_tpu`` checkpoint.

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
for bit; the entropy anneal to JAX's eager ``entropy_coef_at`` bit for bit
and to its jitted one within 2e-9 (XLA may contract the ramp into one fused
multiply-add: an ulp of the 0.01 coefficient).
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
from asyncrl_tpu.learn.learner import _algo_loss, make_optimizer as jmake_optimizer
from asyncrl_tpu.learn.learner import entropy_coef_at as jentropy_coef_at
from asyncrl_tpu.utils.config import Config as JConfig
from asyncrl_tpu.models.networks import build_model as jbuild_model
from asyncrl_tpu.ops.distributions import Categorical as JCategorical
from asyncrl_tpu.rollout.anakin import actor_init as jactor_init, unroll as junroll
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
from asyncrl_tpu_torch.rollout.buffer import Rollout
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


@pytest.mark.parametrize("name", [
    "pong_impala", "atari_impala", "brax_ppo", "cartpole_a3c", "cartpole_impala", "cartpole_ppo",
    "pong_t2t",
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
    for knob in ({"core": "lstm"}, {"backend": "sebulba"}, {"optimizer": "rmsprop"},
                 {"frame_skip": 4}, {"torso": "nature_cnn"}, {"env_id": "JaxBreakout-v0"},
                 {"algo": "qlearn"}):
        with pytest.raises(NotImplementedError):
            cfg.replace(**knob)
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
    config as it was, and off it raises NotImplementedError naming the
    Queue A item that brings it (or that it has no counterpart)."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    missing = {k: v for k, v in jax_fields.items() if k not in ours}
    assert set(missing) == set(LATER_KNOBS)
    for name, (default, _) in LATER_KNOBS.items():
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


@pytest.mark.parametrize("name", ["cartpole_a3c", "cartpole_impala", "cartpole_ppo", "pong_t2t"])
def test_presets_train_on_cpu(name):
    preset = getattr(tpresets, name)
    agent = make_agent(preset, device="cpu", log_every=1, eval_every=0)
    calls = 2
    history = agent.train(
        total_env_steps=calls * preset.batch_steps_per_update * preset.updates_per_call)
    assert agent.state.update_step == calls * preset.updates_per_call
    for window in history:
        assert all(math.isfinite(v) for v in window.values()), window


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
