"""The port's command lines and their plumbing: ``override`` against the
JAX package's on tests/test_api.py's cases and on the knobs the port
leaves at their JAX defaults, ``cli.train`` end to end on the CPU, and
``TensorBoardSink`` against the JAX sink.

The two sinks write the same windows; both event files are read back with
tensorboard's ``EventAccumulator``. The JAX sink writes ``tf.summary``
scalars, which come back as tensors, and the port's as scalars; after
reading each into (tag, step, float32 value), the two must be equal. The
JAX sink imports tensorflow (about 10 s).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from asyncrl_tpu.utils.config import Config as JConfig
from asyncrl_tpu.utils.config import override as joverride
from asyncrl_tpu_torch.cli import train as tcli
from asyncrl_tpu_torch.config import LATER_KNOBS, Config, override
from asyncrl_tpu_torch.configs import presets as tpresets

CASES = [
    ["num_envs=128", "learning_rate=0.001", "algo=impala", "hidden_sizes=128,128"],
    ["mesh_shape=2,-1", "mesh_axes=dcn,dp", "normalize_obs=true", "gamma=0.98"],
    ["channels=(8,16,16)", "remat=1", "env_id=JaxSeaquest-v0", "eval_every=0"],
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_override_agrees_with_jax(case):
    kvs = CASES[case]
    ours, ref = override(Config(), kvs), joverride(JConfig(), kvs)
    for kv in kvs:
        key = kv.split("=", 1)[0]
        assert getattr(ours, key) == getattr(ref, key), key
    # The dict form too.
    assert override(Config(), dict(kv.split("=", 1) for kv in kvs)) == ours


def test_override_refuses_what_jax_refuses():
    cfg = Config()
    for bad in (["nonexistent=1"], ["batch_steps_per_update=100"], ["replace=1"]):
        with pytest.raises(KeyError):
            override(cfg, bad)
        with pytest.raises(KeyError):
            joverride(JConfig(), bad)
    with pytest.raises(ValueError, match="not a bool"):
        override(cfg, ["normalize_obs=maybe"])


def test_override_parses_later_knobs_by_their_jax_default():
    """A knob the port has no field for parses by the type of its JAX
    default: the default is accepted, any other value raises."""
    cfg = tpresets.pong_impala
    assert override(cfg, ["inference_server=false", "serve=true", "replay_slabs=0",
                          "drain_grace_s=30", "gateway_host=127.0.0.1"]) == cfg
    with pytest.raises(NotImplementedError, match="no counterpart"):
        override(cfg, ["smap_check=off"])
    # The divergence rollback's knobs are fields now.
    assert override(cfg, ["rollback_bad_windows=2", "rollback_max_attempts=4"]) == cfg.replace(
        rollback_bad_windows=2, rollback_max_attempts=4)
    # The resume knob is a field now.
    assert override(cfg, ["resume=true"]) == cfg.replace(resume=True)
    # The tracing knobs are fields now.
    assert override(cfg, ["trace=true", "run_dir=runs/x"]) == cfg.replace(
        trace=True, run_dir="runs/x")
    # The run-health knobs are fields now.
    assert override(cfg, ["obs_http_port=9100", "health_window_ttl=2"]) == cfg.replace(
        obs_http_port=9100, health_window_ttl=2)
    # The stall watchdog's knob is a field now.
    assert override(cfg, ["stall_timeout_s=4"]) == cfg.replace(stall_timeout_s=4.0)
    # The shared server's, the replay ring's and the serving tier's knobs
    # are fields now.
    assert override(cfg, ["inference_server=true", "replay_slabs=4"]) == cfg.replace(
        inference_server=True, replay_slabs=4)
    assert override(cfg, ["serve_shed=true", "gateway_port=-1"]) == cfg.replace(
        serve_shed=True, gateway_port=-1)
    with pytest.raises(NotImplementedError, match="no counterpart"):
        override(cfg, ["donate_buffers=yes"])
    # Every later knob's JAX default, written as a string, parses back to it.
    jcfg = JConfig()
    for key, default in LATER_KNOBS.items():
        raw = ",".join(map(str, default)) if isinstance(default, tuple) else str(default)
        assert override(cfg, [f"{key}={raw}"]) == cfg, key
        assert getattr(joverride(jcfg, [f"{key}={raw}"]), key) == default, key


def test_cli_train_on_cpu(tmp_path, capsys):
    jsonl, logdir = tmp_path / "run.jsonl", tmp_path / "tb"
    rc = tcli.main(["cartpole_a3c", "device=cpu", "num_envs=16", "unroll_len=8",
                    "log_every=1", "--steps", str(3 * 16 * 8), "--eval-episodes", "2",
                    "--json", "--jsonl", str(jsonl), "--logdir", str(logdir)])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    windows, last = lines[:-1], lines[-1]
    assert [w["env_steps"] for w in windows] == [128, 256, 384]
    assert last["eval_episodes"] == 2 and math.isfinite(last["mean_return"])
    assert [json.loads(line) for line in jsonl.read_text().splitlines()] == windows
    assert list(logdir.glob("events.out.tfevents.*"))


def test_cli_train_refuses_unknown_and_later_presets():
    """An unknown preset is refused; no JAX preset is left for later: the
    serving tier's and the MuJoCo ones are ported."""
    with pytest.raises(KeyError):
        tcli.main(["no_such_preset", "device=cpu"])
    assert tpresets.get("pong_serve").gateway_port == -1
    assert tpresets.get("mujoco_ant_ppo").host_pool == "gym"
    assert tpresets.get("mujoco_humanoid_ppo").env_id == "Humanoid-v5"


@pytest.mark.parametrize("argv", [
    ["pendulum_native_ppo", "device=cpu", "num_envs=8", "actor_threads=2", "unroll_len=8",
     "ppo_minibatches=2", "log_every=1"],
    ["cartpole_a3c_cpu", "num_envs=2", "actor_threads=2", "unroll_len=8", "log_every=1"],
])
def test_cli_train_runs_the_host_path_presets(argv, capsys):
    """Both host-path presets through the command line, on the CPU: the
    sebulba one with device=cpu, the cpu_async one as it is."""
    rc = tcli.main([*argv, "--steps", str(3 * 8 * 8), "--eval-episodes", "2", "--json"])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    windows, last = lines[:-1], lines[-1]
    assert windows and all(math.isfinite(w["loss"]) for w in windows)
    assert {"param_lag", "learner_stall_frac", "h2d_bytes"} <= set(windows[-1])
    assert last["eval_episodes"] == 2 and math.isfinite(last["mean_return"])


WINDOWS = [
    {"env_steps": 1024, "fps": 51234.5, "loss": 0.123456789, "entropy": 1.7917595,
     "episode_return": -20.5, "note": "not a number", "eval_return": float("nan")},
    {"env_steps": 2048, "fps": 50111.25, "loss": -3.25e-7, "entropy": 1.75,
     "episode_return": -19.0, "episode_count": 3.0, "pop": [1.0, 2.0]},
    {"env_steps": 4096, "loss": 1e30, "grad_norm": np.float32(0.5), "flag": True},
]


def _read(logdir: Path) -> dict[str, list[tuple[int, np.float32]]]:
    """(step, float32 value) by tag, from the scalars or the scalar tensors
    of the event files under ``logdir``."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(str(logdir), size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["scalars"]:
        out[tag] = [(e.step, np.float32(e.value)) for e in acc.Scalars(tag)]
    for tag in acc.Tags()["tensors"]:
        out[tag] = [(e.step, np.float32(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in acc.Tensors(tag)]
    return out


def test_tensorboard_sink_writes_what_the_jax_sink_writes(tmp_path):
    from asyncrl_tpu.utils.metrics import TensorBoardSink as JTensorBoardSink
    from asyncrl_tpu_torch.utils.metrics import TensorBoardSink

    for sink_cls, name in ((JTensorBoardSink, "jax"), (TensorBoardSink, "port")):
        with sink_cls(str(tmp_path / name)) as sink:
            for window in WINDOWS:
                sink(dict(window))
    ours, ref = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert set(ours) == set(ref) == {"fps", "loss", "entropy", "episode_return",
                                     "eval_return", "episode_count", "grad_norm", "flag"}
    for tag in ref:
        steps, values = zip(*ours[tag])
        ref_steps, ref_values = zip(*ref[tag])
        assert steps == ref_steps, tag
        np.testing.assert_array_equal(np.array(values), np.array(ref_values), err_msg=tag)
