"""The port's Pong, PongPixels and CartPole against the JAX envs, step by
step.

Both sides start from the same states (made by the JAX ``init`` and carried
across), take the same actions, and consume the same random values: the JAX
step draws them from its per-env key, and the test derives the very same
values from that key (same splits, same bounds) and hands them to the port.
Pong is compared exactly: states, observations, rewards, flags, ``last_obs``
and the uint8 frames. CartPole is exact too (physics, step counts, flags,
rewards, resets) for every env whose angle's ``sin`` and ``cos`` are the
same in PyTorch and in XLA; for the others (those whose cos or sin differ by
an ulp, about 6% of the angles, counted in the test) each state entry is
held to 1e-6 absolute (a few ulps of the order-1 terms of its Euler update,
which may cancel) and the flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asyncrl_tpu.envs import cartpole as jcartpole
from asyncrl_tpu.envs import pong as jpong
from asyncrl_tpu_torch.envs import cartpole as tcartpole
from asyncrl_tpu_torch.envs import pong as tpong
from asyncrl_tpu_torch.envs import registry as tregistry


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


def jax_draws(keys) -> tpong.PongDraws:
    """The values ``Pong._step_with_opp_delta`` draws from each step key."""

    def one(key):
        serve_key, reset_key = jax.random.split(key)
        fresh_serve_key, side_key = jax.random.split(reset_key)
        uniform = lambda k: jax.random.uniform(  # noqa: E731
            k, (), jnp.float32, -jpong.SERVE_VY, jpong.SERVE_VY
        )
        return uniform(serve_key), jax.random.bernoulli(side_key), uniform(fresh_serve_key)

    serve_vy, toward, reset_vy = (torch.from_numpy(np.array(x)) for x in jax.vmap(one)(keys))
    return tpong.PongDraws(serve_vy, toward, reset_vy)


def to_torch_state(s) -> tpong.PongState:
    return tpong.PongState(
        *(torch.from_numpy(np.array(getattr(s, f))) for f in ("ball", "agent_y", "opp_y", "score", "t"))
    )


def assert_same(jax_x, torch_x, what):
    a = np.asarray(jax_x)
    b = torch_x.numpy()
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert np.array_equal(a, b), f"{what}: {int((a != b).sum())} of {a.size} differ"


def start_states(jenv, batch, max_steps, seed):
    """JAX init states pushed near the interesting edges: scores of 17-20
    (terminal resets at 21 within the run) and step counts near the cap
    (truncations)."""
    rng = np.random.default_rng(seed)
    state = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(seed), batch))
    score = rng.integers(17, 21, size=(batch, 2)).astype(np.int32)
    t = rng.integers(0, max_steps - 5, size=batch).astype(np.int32)
    return state.replace(score=jnp.asarray(score), t=jnp.asarray(t))


@pytest.mark.parametrize("opponent,every", [("tracker", 1), ("predictive", 1), ("tracker", 3)])
def test_pong_steps_match_jax(opponent, every):
    B, steps, max_steps = 48, 70, 60
    jenv = jpong.Pong(opponent, 0.0, max_steps, every)
    tenv = tpong.Pong(opponent, 0.0, max_steps, every)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(7)
    jstate = start_states(jenv, B, max_steps, seed=3)
    tstate = to_torch_state(jstate)
    key = jax.random.PRNGKey(11)
    seen = {"point": 0, "terminated": 0, "truncated": 0}
    for i in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        actions = rng.integers(0, jpong.NUM_ACTIONS, size=B).astype(np.int32)
        jstate, jts = jstep(jstate, jnp.asarray(actions), keys)
        tstate, tts = tenv.step(tstate, torch.from_numpy(actions), jax_draws(keys))
        for f in ("ball", "agent_y", "opp_y", "score", "t"):
            assert_same(getattr(jstate, f), getattr(tstate, f), f"step {i} state.{f}")
        for f in ("obs", "reward", "terminated", "truncated", "last_obs"):
            assert_same(getattr(jts, f), getattr(tts, f), f"step {i} {f}")
        seen["point"] += int((tts.reward != 0).sum())
        seen["terminated"] += int(tts.terminated.sum())
        seen["truncated"] += int(tts.truncated.sum())
    assert all(n > 0 for n in seen.values()), seen


def test_pong_pixels_steps_match_jax():
    B, steps, max_steps = 12, 40, 30
    jenv = jpong.PongPixels(max_steps=max_steps)
    tenv = tpong.PongPixels(max_steps=max_steps)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(5)
    jcore = start_states(jenv._core, B, max_steps, seed=4)
    jstate = jax.vmap(jenv.init)(jax.random.split(jax.random.PRNGKey(2), B)).replace(core=jcore)
    tstate = tenv.init(B, torch.Generator().manual_seed(0), "cpu")
    tstate.core = to_torch_state(jcore)
    tstate.frames = torch.from_numpy(np.array(jstate.frames))
    key = jax.random.PRNGKey(9)
    seen = {"point": 0, "done": 0}
    for i in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        actions = rng.integers(0, jpong.NUM_ACTIONS, size=B).astype(np.int32)
        jstate, jts = jstep(jstate, jnp.asarray(actions), keys)
        tstate, tts = tenv.step(tstate, torch.from_numpy(actions), jax_draws(keys))
        assert_same(jstate.frames, tstate.frames, f"step {i} frames")
        assert_same(jstate.core.ball, tstate.core.ball, f"step {i} ball")
        for f in ("obs", "reward", "terminated", "truncated", "last_obs"):
            assert_same(getattr(jts, f), getattr(tts, f), f"step {i} {f}")
        seen["point"] += int((tts.reward != 0).sum())
        seen["done"] += int(tts.done.sum())
    assert all(n > 0 for n in seen.values()), seen


def test_render_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-0.05, 1.05, size=(4, 64)).astype(np.float32)
    ref = jax.vmap(jpong.render_positions)(*map(jnp.asarray, pos))
    out = tpong.render_positions(*map(torch.from_numpy, pos))
    assert_same(ref, out, "frames")


def test_init_and_registry():
    g = torch.Generator().manual_seed(0)
    env = tregistry.make("JaxPongPixels-v0")
    state = env.init(5, g, "cpu")
    assert env.observe(state).shape == (5, 84, 84, 4)
    assert env.observe(state).dtype == torch.uint8
    core = state.core
    assert torch.all(core.ball[:, :2] == 0.5)
    assert torch.all(core.ball[:, 3].abs() <= jpong.SERVE_VY)
    assert torch.all(core.ball[:, 2].abs() == torch.tensor(jpong.BALL_VX))
    assert "CartPole-v1" in tregistry.registered()
    with pytest.raises(KeyError):
        tregistry.make("JaxBreakout-v0")
    with pytest.raises(ValueError):
        tpong.Pong(opponent="oracle")
    with pytest.raises(NotImplementedError):
        tpong.PongPixels(frame_skip=4)


def test_cartpole_steps_match_jax():
    """256 envs for 620 steps from JAX's states, half of them balanced by a
    PD controller so that episodes reach the 500-step cap, with start
    counts spread over [0, 500): terminations, truncations and auto-resets
    all happen in the run."""
    B, steps = 256, 620
    jenv = jcartpole.CartPole()
    env = tregistry.make("CartPole-v1")
    assert env.spec.obs_shape == (4,) and env.spec.num_actions == 2
    jstep = jax.jit(jax.vmap(jenv.step))
    jinit = jax.jit(jax.vmap(jenv.init))
    jsin, jcos = jax.jit(jnp.sin), jax.jit(jnp.cos)
    rng = np.random.default_rng(3)
    jstate = jinit(jax.random.split(jax.random.PRNGKey(0), B))
    jstate = jstate.replace(t=jnp.asarray(rng.integers(0, 500, B).astype(np.int32)))
    balanced = np.arange(B) % 2 == 0
    seen = {"terminated": 0, "truncated": 0, "inexact_angles": 0, "exact_envs": 0}
    for i in range(steps):
        keys = jax.random.split(jax.random.PRNGKey(1000 + i), B)
        phys = np.array(jstate.phys)
        control = (phys[:, 2] + 0.3 * phys[:, 3] > 0).astype(np.int32)
        action = np.where(balanced, control, rng.integers(0, 2, B).astype(np.int32))
        state = tcartpole.CartPoleState(torch.from_numpy(phys), torch.from_numpy(np.array(jstate.t)))
        draws = tcartpole.CartPoleDraws(torch.from_numpy(np.array(jinit(keys).phys)))
        new, ts = env.step(state, torch.from_numpy(action), draws)
        jstate, jts = jstep(jstate, jnp.asarray(action), keys)

        theta = torch.from_numpy(phys[:, 2])
        same_trig = (
            (torch.sin(theta).numpy() == np.asarray(jsin(phys[:, 2])))
            & (torch.cos(theta).numpy() == np.asarray(jcos(phys[:, 2])))
        )
        seen["inexact_angles"] += int((~same_trig).sum())
        seen["exact_envs"] += int(same_trig.sum())
        for name, ours, ref in (("phys", new.phys, jstate.phys), ("obs", ts.obs, jts.obs),
                                ("last_obs", ts.last_obs, jts.last_obs)):
            ours, ref = ours.numpy(), np.asarray(ref)
            np.testing.assert_array_equal(ours[same_trig], ref[same_trig], err_msg=f"step {i} {name}")
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6, err_msg=f"step {i} {name}")
        for name in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(jts, name)),
                                          err_msg=f"step {i} {name}")
        np.testing.assert_array_equal(new.t.numpy(), np.asarray(jstate.t), err_msg=f"step {i} t")
        ended = (ts.terminated | ts.truncated).numpy()
        assert np.array_equal(new.phys.numpy()[ended], draws.phys.numpy()[ended])
        seen["terminated"] += int(ts.terminated.sum())
        seen["truncated"] += int(ts.truncated.sum())
    assert all(n > 0 for n in seen.values()), seen
    # The ulp-level sin/cos disagreements are a few percent of the angles.
    assert seen["inexact_angles"] < 0.15 * B * steps, seen


def test_cartpole_thresholds_compare_in_f32():
    """``|theta| > THETA_THRESHOLD`` and ``|x| > X_THRESHOLD`` at the f32
    neighbours of each threshold decide as the jitted JAX step does (both
    compare in f32, where the f64 constant rounds)."""
    cases = []
    for index, thr in ((2, jcartpole.THETA_THRESHOLD), (0, jcartpole.X_THRESHOLD)):
        f = np.float32(thr)
        for v in (np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(np.inf))):
            for sign in (1, -1):
                phys = np.zeros(4, np.float32)
                phys[index] = sign * v
                cases.append(phys)
    phys = np.stack(cases)
    # A zero step: tau * 0 velocities leave x and theta where they are.
    B = len(phys)
    jstate = jcartpole.CartPoleState(phys=jnp.asarray(phys), t=jnp.zeros(B, jnp.int32))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    action = np.zeros(B, np.int32)
    _, jts = jax.jit(jax.vmap(jcartpole.CartPole().step))(jstate, jnp.asarray(action), keys)
    state = tcartpole.CartPoleState(torch.from_numpy(phys), torch.zeros(B, dtype=torch.int32))
    draws = tcartpole.CartPoleDraws(torch.zeros(B, 4))
    _, ts = tcartpole.CartPole().step(state, torch.from_numpy(action), draws)
    np.testing.assert_array_equal(ts.last_obs.numpy()[:, [0, 2]], np.asarray(jts.last_obs)[:, [0, 2]])
    np.testing.assert_array_equal(ts.terminated.numpy(), np.asarray(jts.terminated))
    assert 0 < int(ts.terminated.sum()) < B
