"""The plain reference against the system at small sizes on the CPU. The
tests import both; the reference imports nothing of the system."""

import pytest
import torch

from portbench import cells, harness, weights
from portbench.reference import pong_pixels
from portbench.tests.conftest import SMALL


def test_plain_pong_steps_as_the_system_does():
    """Frames, rewards and episode ends equal, bit for bit, over 400 steps
    of random play with episodes cut at 50 steps."""
    from asyncrl_tpu_torch.envs.pong import PongPixels

    B = 64
    system, plain = PongPixels(max_steps=50), pong_pixels.PongPixels(max_steps=50)
    g_sys, g_ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    acts = torch.Generator().manual_seed(4)
    s_sys, s_ref = system.init(B, g_sys, "cpu"), plain.init(B, g_ref, "cpu")
    assert torch.equal(system.observe(s_sys), s_ref["frames"])
    ends = 0
    for _ in range(400):
        action = torch.randint(0, 6, (B,), generator=acts)
        s_sys, ts = system.step(s_sys, action, system.draw(B, g_sys, "cpu"))
        s_ref, reward, terminated, truncated = plain.step(s_ref, action, plain.draw(B, g_ref, "cpu"))
        assert torch.equal(ts.obs, s_ref["frames"])
        assert torch.equal(ts.reward, reward)
        assert torch.equal(ts.terminated, terminated) and torch.equal(ts.truncated, truncated)
        ends += int((terminated | truncated).sum())
    assert ends >= 8 * B


@pytest.mark.parametrize("workload, program", [
    ("atari_impala.b1024", {}), ("atari_nature_cnn.b1024", {}),
    ("atari_impala.b1024", {"channels": [24, 48, 40]})])
def test_plain_forward_is_the_systems_at_f32(workload, program):
    """At each configuration's widths, and at other channels of the IMPALA
    torso, which the reference reads from the configuration too."""
    from asyncrl_tpu_torch.config import Config
    from asyncrl_tpu_torch.envs.core import EnvSpec
    from asyncrl_tpu_torch.models.networks import build_model

    cell = cells.load(workload)
    cell.config = {**cell.config, "program": {**cell.config["program"], **program}}
    model = cell.model()
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in program.items()}
    spec = EnvSpec(obs_shape=(84, 84, 4), num_actions=6, obs_dtype=torch.uint8)
    system = build_model(Config(torso=cell.program["torso"], precision="f32", device="cpu",
                                **kwargs), spec, torch.Generator().manual_seed(0))
    assert {n: p.shape for n, p in system.named_parameters()} == {
        n: torch.Size(shape) for n, (shape, _) in model.param_specs(6).items()}
    w = weights.make(model.param_specs(6), 1, "cpu")
    with torch.no_grad():
        for name, p in system.named_parameters():
            p.copy_(w[name])
    obs = torch.randint(0, 2, (5, 84, 84, 4), dtype=torch.uint8)
    with torch.no_grad():
        got = system(obs)
        want = model.forward(w, obs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", ["atari_impala.b1024", "atari_nature_cnn.b1024",
                                      "atari_impala.b1024_accum4_remat"])
def test_reference_follows_the_system_at_f32(workload):
    """With the torso in float32 the system's first three updates are the
    reference's to float32's rounding; the envs match exactly. The weights'
    change is looser: Adam's first steps move an entry by about the rate
    whatever its gradient's size, so a gradient near zero that rounds to
    the other sign moves it the other way."""
    cell = cells.load(workload)
    cell.traffic = {**cell.traffic, "program": {**cell.traffic["program"], **SMALL}}
    cell.config = {**cell.config, "program": {**cell.config["program"], "precision": "f32"}}
    agent, w = harness.build(cell, 5, "cpu")
    record = harness.checked_updates(agent)
    del agent
    numbers = harness.compare(cell, 5, w, record, "cpu")
    assert numbers["env_mismatch"] == 0
    assert numbers["action_gap"] == 0.0
    for name in ("logp_gap", "loss_gap", "grad_gap"):
        assert numbers[name] < 1e-4, (name, numbers)
    assert numbers["change_gap"] < 1e-3, numbers
    assert len(record["losses"]) == len(record["fragments"]) == harness.CHECKED_UPDATES
