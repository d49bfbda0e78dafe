"""The workload presets the port runs: copies of ``cartpole_a3c``,
``cartpole_impala``, ``cartpole_ppo``, ``pong_impala``, ``pong_t2t``,
``atari_impala`` and ``brax_ppo`` from ``asyncrl_tpu/configs/presets.py``."""

from __future__ import annotations

from asyncrl_tpu_torch.config import Config

# CartPole-v1, A3C: the reference's smoke test, its four async actors a
# vectorised batch of 64 envs.
cartpole_a3c = Config(
    env_id="CartPole-v1",
    algo="a3c",
    num_envs=64,
    unroll_len=32,
    total_env_steps=400_000,
    learning_rate=1e-3,
    entropy_coef=0.01,
    gamma=0.99,
)
cartpole_impala = cartpole_a3c.replace(algo="impala", actor_staleness=2)
cartpole_ppo = cartpole_a3c.replace(algo="ppo", learning_rate=3e-4)

# PongNoFrameskip-v4 stand-in: vector Pong, IMPALA V-trace, 256 envs.
pong_impala = Config(
    env_id="JaxPong-v0",
    algo="impala",
    num_envs=256,
    unroll_len=32,
    total_env_steps=5_000_000,
    learning_rate=6e-4,
    entropy_coef=0.01,
    torso="mlp",
    hidden_sizes=(256, 256),
    actor_staleness=2,
)

# The time-to-target recipe that trained runs/pong18_tpu: a living cost
# that prices long rallies, a longer horizon, and an entropy anneal to 1e-4
# over 30,000 updates, 32 updates a call and a 32-episode eval every 40
# calls.
pong_t2t = pong_impala.replace(
    step_cost=0.01,
    gamma=0.995,
    learning_rate=1.5e-4,
    entropy_coef_final=1e-4,
    entropy_anneal_steps=30_000,
    updates_per_call=32,
    eval_every=40,
    eval_episodes=32,
    total_env_steps=20_000_000_000,
)

# Atari-57 stand-in: 84x84x4 pixel Pong, IMPALA-CNN torso, 1024 envs.
atari_impala = pong_impala.replace(
    env_id="JaxPongPixels-v0", num_envs=1024, torso="impala_cnn"
)

# "Brax Ant/Humanoid, PPO, 8192 envs" stand-in: Pendulum swing-up (one
# continuous torque), PPO + GAE, 4 epochs x 8 minibatches of 65,536 samples.
brax_ppo = Config(
    env_id="JaxPendulum-v0",
    algo="ppo",
    num_envs=8192,
    unroll_len=64,
    total_env_steps=10_000_000,
    learning_rate=1e-3,
    gamma=0.95,
    gae_lambda=0.95,
    entropy_coef=0.001,
    reward_scale=0.1,
    ppo_epochs=4,
    ppo_minibatches=8,
)
