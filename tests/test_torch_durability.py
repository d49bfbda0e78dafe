"""The port's preemption drain (``asyncrl_tpu_torch/runtime/durability.py``,
``SebulbaTrainer.train``) held to the JAX package's.

- Counterparts of JAX's coordinator and gate cases
  (``tests/test_durability.py:128-199,320-375``): the deadline watchdog
  (its ``os._exit`` injected), ``finish``, an idempotent ``request``, the
  second signal's hard exit, ``install`` a no-op off the main thread, the
  scripted preempt's registration, the grace's validation and environment
  precedence, ``SLOGate.close`` and the refused preempt spec.
- A scripted preempt (``actor.queue_put:preempt:1.0:0:max=1,after=16``) on
  ``cartpole_a3c_cpu`` in both packages: each raises ``PreemptedExit``
  (code 86), leaves a final checkpoint with its manifest at the state's
  step, and flushes a last window with ``drain_preempt``.
- A real SIGTERM to a child process training the port's
  ``cartpole_a3c_cpu``: it exits 86, and its final checkpoint restores to
  the parameters it printed.
- The divergence rollback. ``RollbackPolicy`` against JAX's on event
  sequences drawn from a numpy seed: the same actions, ``last_good_step``
  and ``event()`` dicts, and the same validation errors. The learner's NaN
  guard against JAX's (A3C, IMPALA with both normalizations, IMPALA with the
  replay anchor, multipass PPO, and ``updates_per_call=2``), weights carried
  across: a non-finite update holds the port's state bit for bit (JAX's too)
  with the same ``nonfinite_skip``, clean updates within the learner
  comparisons' 1e-5 relative (metrics) and 1e-6 absolute (weights), and the
  PPO shuffles after a skip are the skipped update's in both packages. The
  guard off is the update without it, bit for bit and without the key.
  JAX's end-to-end scripts (``tests/test_durability.py:383,508-600``) on the
  port, ``run_state``'s attempts across a resume, and a rollback window
  skipping the elastic controller.
"""

import glob
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asyncrl_tpu import make_agent as jmake_agent
from asyncrl_tpu.configs import presets as jpresets
from asyncrl_tpu.envs import registry as jregistry
from asyncrl_tpu.learn.rollout_learner import RolloutLearner as JRolloutLearner
from asyncrl_tpu.models.networks import build_model as jbuild_model
from asyncrl_tpu.parallel.mesh import make_mesh as jmake_mesh
from asyncrl_tpu.rollout.buffer import Rollout as JRollout
from asyncrl_tpu.runtime import durability as jdurability
from asyncrl_tpu.utils import faults as jfaults
from asyncrl_tpu.utils.config import Config as JConfig
from asyncrl_tpu_torch import make_agent
from asyncrl_tpu_torch.api.sebulba_trainer import _stack_fragments
from asyncrl_tpu_torch.config import Config
from asyncrl_tpu_torch.configs import presets as tpresets
from asyncrl_tpu_torch.envs import registry as tregistry
from asyncrl_tpu_torch.learn.rollout_learner import RolloutLearner
from asyncrl_tpu_torch.models.convert import params_from_jax
from asyncrl_tpu_torch.models.networks import build_model
from asyncrl_tpu_torch.obs import registry as obs_registry
from asyncrl_tpu_torch.rollout.buffer import Rollout
from asyncrl_tpu_torch.rollout.inference_server import ServerClosed
from asyncrl_tpu_torch.runtime import durability
from asyncrl_tpu_torch.runtime.durability import (
    EXIT_DEADLINE,
    EXIT_DRAINED,
    DrainCoordinator,
    PreemptedExit,
    RollbackPolicy,
)
from asyncrl_tpu_torch.serve.slo import SLOGate
from asyncrl_tpu_torch.utils import faults
from asyncrl_tpu_torch.utils.checkpoint import Checkpointer, state_dict

ROOT = Path(__file__).resolve().parents[1]
PREEMPT = "actor.queue_put:preempt:1.0:0:max=1,after=16"


@pytest.fixture(autouse=True)
def _disarm_after():
    """No test's armed fault registry may leak into the next."""
    yield
    faults.disarm()
    jfaults.disarm()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread, as in the port's other comparisons."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_exit_codes_are_the_jax_packages():
    assert (EXIT_DRAINED, EXIT_DEADLINE) == (jdurability.EXIT_DRAINED, jdurability.EXIT_DEADLINE)
    assert PreemptedExit(signal.SIGTERM).code == 86 and isinstance(PreemptedExit(), SystemExit)


# ------------------------------------------------- drain coordinator units


class _ExitRecorder:
    def __init__(self):
        self.codes = []

    def __call__(self, code):
        self.codes.append(code)


def test_drain_deadline_watchdog_hard_kills():
    # The watchdog thread is joined, not slept on: it exits once it has
    # decided (fired or disarmed).
    rec = _ExitRecorder()
    c = DrainCoordinator(grace_s=0.15, exit_fn=rec)
    c.request(reason="test")
    c._watchdog.join(timeout=30.0)
    assert not c._watchdog.is_alive(), "watchdog did not decide in 30s"
    assert rec.codes == [EXIT_DEADLINE]


def test_drain_finish_disarms_the_watchdog():
    rec = _ExitRecorder()
    c = DrainCoordinator(grace_s=30.0, exit_fn=rec)
    c.request(reason="test")
    c.finish()
    c._watchdog.join(timeout=30.0)
    assert not c._watchdog.is_alive(), "watchdog did not disarm"
    assert rec.codes == []


def test_drain_request_is_idempotent():
    rec = _ExitRecorder()
    c = DrainCoordinator(grace_s=30.0, exit_fn=rec)
    c.request(reason="first")
    wd = c._watchdog
    c.request(reason="second")  # no second watchdog
    assert c._watchdog is wd and c.requested
    c.finish()


def test_second_signal_hard_kills_immediately():
    rec = _ExitRecorder()
    c = DrainCoordinator(grace_s=30.0, exit_fn=rec)
    c._handle(15, None)  # first: requests the drain
    assert c.requested and rec.codes == [] and c.signum == 15
    c._handle(15, None)  # second: the operator insisted
    assert rec.codes == [EXIT_DEADLINE]
    c.finish()


def test_install_off_main_thread_is_a_noop():
    c = DrainCoordinator(grace_s=1.0, exit_fn=_ExitRecorder())
    result = {}
    t = threading.Thread(target=lambda: result.update(r=c.install()))
    t.start()
    t.join()
    assert result["r"] is False and not c.installed


def test_install_on_the_main_thread_routes_sigterm_and_restores():
    c = DrainCoordinator(grace_s=30.0, exit_fn=_ExitRecorder())
    before = signal.getsignal(signal.SIGTERM)
    assert c.install() is True and c.installed
    try:
        signal.raise_signal(signal.SIGTERM)
        assert c.requested and c.signum == signal.SIGTERM
    finally:
        c.finish()
        c.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before and not c.installed


def test_scripted_preempt_requires_an_active_coordinator():
    assert durability.scripted_preempt() is False
    c = DrainCoordinator(grace_s=5.0, exit_fn=_ExitRecorder())
    durability.set_active(c)
    try:
        # Not installed (no handler): falls back to the direct request.
        assert durability.scripted_preempt() is True
        assert c.requested
        c.finish()
    finally:
        durability.clear_active(c)
    assert durability.active() is None


def test_grace_validation_and_env_precedence(monkeypatch):
    with pytest.raises(ValueError):
        DrainCoordinator(grace_s=0.0)
    cfg = Config(env_id="CartPole-v1", algo="impala", num_envs=8, unroll_len=8,
                 drain_grace_s=7.0)
    assert cfg.replace(resume=False) == cfg  # the knob's default
    assert durability.drain_grace(cfg) == 7.0
    assert durability.drain_grace(Config()) == jdurability.drain_grace(jpresets.pong_impala)
    monkeypatch.setenv("ASYNCRL_DRAIN_GRACE_S", "3.5")
    assert durability.drain_grace(cfg) == 3.5
    monkeypatch.setenv("ASYNCRL_DRAIN_GRACE_S", "soon")
    with pytest.raises(ValueError, match="ASYNCRL_DRAIN_GRACE_S"):
        durability.drain_grace(cfg)
    assert durability.resume_enabled(cfg) is False
    monkeypatch.setenv("ASYNCRL_RESUME", "1")
    assert durability.resume_enabled(cfg) is True
    monkeypatch.setenv("ASYNCRL_RESUME", "false")
    assert durability.resume_enabled(cfg) is False
    # The knob is a field now, and the variable wins over it, as in JAX.
    assert durability.resume_enabled(cfg.replace(resume=True)) is False
    monkeypatch.delenv("ASYNCRL_RESUME")
    assert durability.resume_enabled(cfg.replace(resume=True)) is True


# --------------------------------------------------------- SLOGate close


def test_slo_gate_close_refuses_new_admissions():
    gate = SLOGate(max_inflight=2)
    gate.admit()  # in flight before the drain
    gate.close()
    assert gate.closed
    with pytest.raises(ServerClosed, match="drain"):
        gate.admit()
    gate.finished(1.0)  # the admitted request still completes normally


def test_slo_gate_close_wakes_a_waiting_admitter():
    gate = SLOGate(max_inflight=1)
    gate.admit()  # fills the cap; the next admit blocks
    err = {}
    parked = threading.Event()

    def waiter():
        try:
            parked.set()
            gate.admit(timeout_s=10.0)
        except ServerClosed as e:
            err["e"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert parked.wait(5.0)
    deadline = time.monotonic() + 5.0
    while not gate._cond._waiters:
        assert time.monotonic() < deadline, "admitter never parked"
        time.sleep(0.001)
    gate.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and "e" in err


# ----------------------------------------------------------- validation


def _sebulba_cfg(**kw):
    base = dict(env_id="CartPole-v1", algo="a3c", backend="sebulba", host_pool="jax",
                num_envs=16, actor_threads=2, unroll_len=4, precision="f32", log_every=2,
                device="cpu")
    base.update(kw)
    return Config(**base)


def test_preempt_spec_refused_when_drain_disabled():
    with pytest.raises(ValueError, match="preempt"):
        make_agent(_sebulba_cfg(drain_grace_s=0.0, fault_spec=PREEMPT))
    assert faults.active() is None  # a failed construction disarms


def test_preempt_arms_only_at_the_ported_site():
    """``actor.queue_put`` takes the preempt kind and, with the supervision
    slice's watchdog, its crash and stall; a preempt at another site arms as
    JAX's registry arms it."""
    assert faults.arm(PREEMPT).has_kind("preempt")
    for spec in ("actor.queue_put:crash:1.0:0", "actor.queue_put:stall:1.0:0",
                 "actor.step:preempt:1.0:0"):
        ((name, site),) = faults.arm(spec)._sites.items()
        ((jname, jsite),) = jfaults.FaultRegistry(spec)._sites.items()
        assert (name, site.kind, site.prob) == (jname, jsite.kind, jsite.prob)


# -------------------------------------------- e2e: scripted preempt drain


def _port_drain(tmp_path):
    cfg = tpresets.cartpole_a3c_cpu.replace(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2, log_every=2,
        fault_spec=PREEMPT)
    target = cfg.num_envs * cfg.unroll_len * 1000
    windows = []
    agent = make_agent(cfg)
    try:
        before = signal.getsignal(signal.SIGTERM)
        with pytest.raises(PreemptedExit) as excinfo:
            agent.train(total_env_steps=target, callback=windows.append)
        assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
        assert durability.active() is None
        return agent, excinfo.value, windows, target
    finally:
        agent.close()


def test_scripted_preempt_drains_like_jax(tmp_path):
    """``cartpole_a3c_cpu`` with a scripted SIGTERM after 16 fragment
    hand-offs: in the port and in the JAX package, ``train`` raises
    ``PreemptedExit`` (code 86) short of the target, the final checkpoint
    and its manifest hold the state's step, and the last window flushed is
    the drain's, with ``drain_preempt``."""
    agent, exc, windows, target = _port_drain(tmp_path / "port")
    assert exc.code == EXIT_DRAINED and exc.signum == signal.SIGTERM
    assert 0 < agent.env_steps < target
    step = agent.state.update_step
    ck = Checkpointer(str(tmp_path / "port" / "ck"), create=False)
    assert ck.latest_step() == step > 0
    manifest = ck.read_manifest(step)
    assert manifest is not None and manifest["env_steps"] == agent.env_steps
    last = windows[-1]
    assert last["drain_preempt"] == 1.0 and last["env_steps"] == agent.env_steps
    assert last["fault_actor.queue_put"] == 1
    assert not any("drain_preempt" in w for w in windows[:-1])

    run_dir = tmp_path / "jax" / "run"
    jcfg = jpresets.cartpole_a3c_cpu.replace(
        checkpoint_dir=str(tmp_path / "jax" / "ck"), checkpoint_every=2, log_every=2,
        run_dir=str(run_dir), obs_http_port=-1, health_stall_frac=1.0,
        health_fps_collapse=0.0, fault_spec=PREEMPT)
    jagent = jmake_agent(jcfg)
    try:
        with pytest.raises(jdurability.PreemptedExit) as jexc:
            jagent.train(total_env_steps=target)
        assert jexc.value.code == exc.code
        assert 0 < jagent.env_steps < target
        jstep = jagent._ckpt.checkpointer.latest_step()
        assert jstep is not None and jstep > 0
        assert jagent._ckpt.checkpointer.read_manifest(jstep) is not None
    finally:
        jagent.close()
    flushes = []
    with open(run_dir / "timeseries.jsonl") as f:
        for line in f:
            doc = json.loads(line)
            if doc.get("kind") == "sample":
                flushes.append(bool(doc["window"].get("drain_preempt")))
    assert flushes and flushes[-1] and not any(flushes[:-1])


# ------------------------------------------------ e2e: a real SIGTERM

CHILD = """
import hashlib, json, sys
import torch
from asyncrl_tpu_torch import make_agent
from asyncrl_tpu_torch.configs import presets
from asyncrl_tpu_torch.utils.checkpoint import state_dict

torch.set_num_threads(1)
cfg = presets.cartpole_a3c_cpu.replace(checkpoint_dir=sys.argv[1], checkpoint_every=1000,
                                       log_every=1)
agent = make_agent(cfg)

def params_sha():
    flat = state_dict(agent.state)
    h = hashlib.sha256()
    for k in sorted(flat):
        if k.startswith("params."):
            h.update(k.encode())
            h.update(flat[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()

def callback(window):
    if window.get("drain_preempt"):
        print(json.dumps({"drained": agent.state.update_step, "sha": params_sha()}), flush=True)
    else:
        print(json.dumps({"window": window["env_steps"]}), flush=True)

agent.train(total_env_steps=10**9, callback=callback)
"""


def _params_sha(flat) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        if k.startswith("params."):
            h.update(k.encode())
            h.update(flat[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def test_real_sigterm_drains_and_exits_86(tmp_path):
    """A child process trains ``cartpole_a3c_cpu``; after its first window
    it gets a real SIGTERM. It exits 86, and ``make_agent(restore=)`` on its
    final checkpoint gives the parameters whose SHA-256 it printed at the
    drain, at the step it printed."""
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(ck)], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = json.loads(proc.stdout.readline())
        assert "window" in first, first
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        drain_s = time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == EXIT_DRAINED, err[-2000:]
    assert "drain requested" in err and drain_s < 30.0
    drained = [json.loads(line) for line in out.splitlines() if "drained" in line]
    assert len(drained) == 1
    step, sha = drained[0]["drained"], drained[0]["sha"]
    assert Checkpointer(str(ck), create=False).latest_step() == step
    assert glob.glob(str(ck / f"manifest-{step}.json"))
    restored = make_agent(tpresets.cartpole_a3c_cpu, restore=str(ck))
    try:
        assert restored.state.update_step == step
        assert _params_sha(state_dict(restored.state)) == sha
    finally:
        restored.close()


# ------------------------------------------------------ rollback policy

_DETECTORS = ("nonfinite_loss", "grad_explosion", "entropy_collapse", "learner_stall",
              "fps_collapse", "restart_storm", "slo_breach")


class _Event:
    def __init__(self, detector):
        self.detector = detector


def _event_sequence(seed: int, windows: int = 60):
    """Windows of health events and the checkpointer's newest step: clean
    stretches, bad streaks of trigger detectors, windows of non-trigger
    detectors only, and windows with no retained step yet."""
    rng = np.random.default_rng(seed)
    step, out, bad = None, [], 0
    for _ in range(windows):
        if bad == 0 and rng.uniform() < 0.25:
            bad = int(rng.integers(1, 6))  # the next streak's length
        if bad:
            bad -= 1
            dets = list(rng.choice(_DETECTORS[:3], size=int(rng.integers(1, 3))))
            dets += list(rng.choice(_DETECTORS[3:], size=int(rng.integers(0, 2))))
        else:
            dets = list(rng.choice(_DETECTORS[3:], size=int(rng.integers(0, 3))))
        if step is None and rng.uniform() < 0.7:
            step = 0
        if step is not None and rng.uniform() < 0.6:
            step += 2
        out.append((dets, step))
    return out


POLICY_CASES = [(1, 1, 0, 0), (1, 3, 2, 1), (2, 2, 2, 2), (2, 3, 0, 3), (3, 2, 1, 4),
                (2, 5, 3, 5), "validation"]


@pytest.mark.parametrize("case", POLICY_CASES, ids=str)
def test_rollback_policy_matches_jax(case):
    """The same event sequences through both packages' ``RollbackPolicy``:
    the same actions (kind, detail, detectors, attempts) and ``event()``
    dicts, the same ``last_good_step`` after every window; and the same
    validation errors."""
    if case == "validation":
        for kwargs in (dict(bad_windows=0, max_attempts=1), dict(bad_windows=1, max_attempts=0),
                       dict(bad_windows=1, max_attempts=1, cooldown_windows=-1)):
            with pytest.raises(ValueError) as ours:
                RollbackPolicy(**kwargs)
            with pytest.raises(ValueError) as ref:
                jdurability.RollbackPolicy(**kwargs)
            assert str(ours.value) == str(ref.value)
        assert durability.TRIGGER_DETECTORS == jdurability.TRIGGER_DETECTORS
        assert durability.COOLDOWN_WINDOWS == jdurability.COOLDOWN_WINDOWS
        return
    bad_windows, max_attempts, cooldown, seed = case
    ours = RollbackPolicy(bad_windows, max_attempts, cooldown)
    ref = jdurability.RollbackPolicy(bad_windows, max_attempts, cooldown)
    kinds = set()
    for dets, step in _event_sequence(seed):
        events = [_Event(d) for d in dets]
        a, b = ours.on_window(events, step), ref.on_window(events, step)
        assert (a is None) == (b is None)
        if a is not None:
            kinds.add(a.kind)
            assert (a.kind, a.detail, a.detectors, a.attempts) == (
                b.kind, b.detail, b.detectors, b.attempts)
            assert a.event() == b.event()
        assert (ours.last_good_step, ours.attempts) == (ref.last_good_step, ref.attempts)
    assert {"quarantine", "rollback"} <= kinds or "abort" in kinds


# ------------------------------------------------------------ NaN guard

GUARD_CASES = {
    "a3c": ("CartPole-v1", dict(algo="a3c"), 1),
    "impala_norm": ("CartPole-v1", dict(algo="impala", normalize_obs=True,
                                        normalize_returns=True), 1),
    "impala_replay": ("CartPole-v1", dict(algo="impala", replay_slabs=2,
                                          target_update_period=1), 1),
    "ppo": ("JaxPendulum-v0", dict(algo="ppo", ppo_epochs=2, ppo_minibatches=4,
                                   hidden_sizes=(32, 32), learning_rate=1e-3), 1),
    "impala_k2": ("CartPole-v1", dict(algo="impala", learning_rate=1e-2), 2),
    "ppo_k2": ("JaxPendulum-v0", dict(algo="ppo", ppo_epochs=2, ppo_minibatches=4,
                                      hidden_sizes=(32, 32), learning_rate=1e-3), 2),
}
T, B = 8, 16


def _synthetic(obs_dim, continuous, seed, returns=False, nan=False):
    rng = np.random.default_rng(seed)
    actions = (rng.normal(size=(T, B, 1)).astype(np.float32) if continuous
               else rng.integers(0, 2, (T, B)).astype(np.int32))
    frag = dict(
        obs=rng.normal(size=(T, B, obs_dim)).astype(np.float32),
        actions=actions,
        behaviour_logp=rng.normal(-0.9, 0.2, (T, B)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        terminated=rng.uniform(size=(T, B)) < 0.1,
        truncated=rng.uniform(size=(T, B)) < 0.05,
        bootstrap_obs=rng.normal(size=(B, obs_dim)).astype(np.float32),
        disc_returns=rng.normal(size=(T, B)).astype(np.float32) if returns else None,
    )
    if nan:
        frag["rewards"][0, 0] = np.nan
    return frag


def _stacked(frags):
    return {k: None if frags[0][k] is None else np.stack([f[k] for f in frags])
            for k in frags[0]}


def _guard_learners(env_id, knobs, K, bad_windows=2):
    """JAX's and the port's host learner on one set of flax weights (seed 0),
    the guard armed with ``bad_windows``."""
    knobs = dict(knobs, backend="sebulba", updates_per_call=K,
                 rollback_bad_windows=bad_windows)
    jcfg = JConfig(env_id=env_id, precision="f32", fused_scan="interpret", **knobs)
    tcfg = Config(env_id=env_id, precision="f32", device="cpu", **knobs)
    jspec, spec = jregistry.make(env_id).spec, tregistry.make(env_id).spec
    jmodel = jbuild_model(jcfg, jspec)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, *jspec.obs_shape)))
    tmodel = params_from_jax(jax.device_get(jparams), build_model(tcfg, spec, torch.Generator()))
    jlearner = JRolloutLearner(jcfg, jspec, jmodel, jmake_mesh((1,), ("dp",), jax.devices("cpu")[:1]))
    jstate = jlearner.init_state(0).replace(params=jparams,
                                            opt_state=jlearner.optimizer.init(jparams))
    if jstate.target_params is not None:
        jstate = jstate.replace(target_params=jparams)
    learner = RolloutLearner(tcfg, spec, tmodel)
    return jcfg, tcfg, spec, jlearner, jstate, learner, learner.init_state(0)


def _jax_perms(jcfg, step):
    """JAX's shuffles of a multipass PPO update at ``update_step`` ``step``,
    as the port takes them (``tests/test_torch_sebulba.py``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 0x5EB), step)
    key = jax.random.fold_in(key, jnp.zeros((), jnp.int32))
    return [torch.from_numpy(np.array(jax.random.permutation(k, T * B)))
            for k in jax.random.split(key, jcfg.ppo_epochs)]


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_nan_guard_matches_jax(case):
    """Clean, poisoned (``rewards[0, 0] = NaN``) and clean fragments (with
    ``updates_per_call=2``, the poisoned one second in the first call and
    first in the second): the port's state holds bit for bit over every
    skipped update and JAX's holds too, ``nonfinite_skip`` is JAX's, and
    the applied updates match JAX's within the learner comparisons'
    tolerance. Multipass PPO's shuffles are JAX's at JAX's update count,
    which the skip holds."""
    env_id, knobs, K = GUARD_CASES[case]
    jcfg, tcfg, spec, jlearner, jstate, learner, state = _guard_learners(env_id, knobs, K)
    obs_dim, cont = spec.obs_shape[0], spec.continuous
    frags = [_synthetic(obs_dim, cont, seed=i, returns=tcfg.normalize_returns, nan=(i == 1))
             for i in range(3)]
    calls = [[f] for f in frags] if K == 1 else [frags[:2], frags[1:]]
    jstep = 0
    for c, rows in enumerate(calls):
        frag = rows[0] if K == 1 else _stacked(rows)
        perms = None
        if tcfg.algo == "ppo":
            perms = []
            for row in rows:
                perms.append(_jax_perms(jcfg, jstep))
                jstep += 0 if np.isnan(row["rewards"]).any() else 1
        before, jbefore = state_dict(state), jax.tree.leaves(jstate)
        jstate, jm = jlearner.update(jstate, jlearner.put_rollout(JRollout(**frag)))
        state, m = learner.update(state, learner.put_rollout(Rollout(**frag)), perms)
        assert set(m) == set(jm) and "nonfinite_skip" in m
        skips = np.atleast_1d(np.asarray(m["nonfinite_skip"]))
        np.testing.assert_array_equal(skips, np.atleast_1d(np.asarray(jm["nonfinite_skip"])))
        assert list(skips) == [float(np.isnan(r["rewards"]).any()) for r in rows]
        if K == 1 and skips[0]:
            assert not np.isfinite(float(m["loss"])) and not np.isfinite(float(jm["loss"]))
            _assert_state_equal(state_dict(state), before)
            for a, b in zip(jax.tree.leaves(jstate), jbefore):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            continue
        for k, v in jm.items():
            applied = np.atleast_1d(np.asarray(v))[skips == 0]
            ours = np.atleast_1d(m[k].numpy())[skips == 0]
            np.testing.assert_allclose(ours, applied, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} at call {c}")
    assert state.update_step == int(jstate.update_step) == len(frags) - 1
    ref = params_from_jax(jax.device_get(jstate.params), build_model(tcfg, spec, torch.Generator()))
    for (name, r), p in zip(ref.named_parameters(), state.params.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    if tcfg.normalize_obs:
        np.testing.assert_allclose(state.obs_stats.mean.numpy(),
                                   np.asarray(jstate.obs_stats.mean), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(state.ret_stats.m2), float(jstate.ret_stats.m2),
                                   rtol=1e-6)


def test_ppo_draw_after_a_skip_is_the_skipped_updates():
    """Multipass PPO with its shuffles drawn by each package itself: clean,
    poisoned, clean ends where clean, clean ends, bit for bit, in the port
    (the skip puts the generator back) and in JAX (its key is the held
    update count)."""
    env_id, knobs, _ = GUARD_CASES["ppo"]
    spec = tregistry.make(env_id).spec
    frags = [_synthetic(spec.obs_shape[0], spec.continuous, seed=i, nan=(i == 1))
             for i in range(3)]

    def run(order):
        jcfg, _, _, jlearner, jstate, learner, state = _guard_learners(env_id, knobs, 1)
        for i in order:
            jstate, _ = jlearner.update(jstate, jlearner.put_rollout(JRollout(**frags[i])))
            state, _ = learner.update(state, learner.put_rollout(Rollout(**frags[i])))
        return jstate, state

    (jskipped, skipped), (jclean, clean) = run((0, 1, 2)), run((0, 2))
    _assert_state_equal(state_dict(skipped), state_dict(clean))
    for a, b in zip(jax.tree.leaves(jskipped), jax.tree.leaves(jclean)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("algo", ["impala", "ppo"])
def test_nan_guard_off_is_the_unguarded_update(algo, monkeypatch):
    """``rollback_bad_windows=0`` never reaches the guard and gives JAX's
    metric keys (no ``nonfinite_skip``); armed on clean fragments the state
    is the unarmed one's, bit for bit, and the metrics add only the key."""
    env_id, knobs, _ = GUARD_CASES["impala_norm" if algo == "impala" else "ppo"]
    spec = tregistry.make(env_id).spec
    frags = [_synthetic(spec.obs_shape[0], spec.continuous, seed=i, returns=True)
             for i in range(2)]
    jcfg, _, _, jlearner, jstate, off, off_state = _guard_learners(env_id, knobs, 1, 0)
    *_, on, on_state = _guard_learners(env_id, knobs, 1, 2)
    assert not off.nan_guard and on.nan_guard
    monkeypatch.setattr(off, "_guarded_once", None)  # a call would raise
    for frag in frags:
        _, jm = jlearner.update(jstate, jlearner.put_rollout(JRollout(**frag)))
        off_state, m_off = off.update(off_state, off.put_rollout(Rollout(**frag)))
        on_state, m_on = on.update(on_state, on.put_rollout(Rollout(**frag)))
        assert set(m_off) == set(jm) and "nonfinite_skip" not in m_off
        assert set(m_on) == set(m_off) | {"nonfinite_skip"} and float(m_on["nonfinite_skip"]) == 0
        for k in m_off:
            assert torch.equal(m_off[k], m_on[k]), k
    _assert_state_equal(state_dict(off_state), state_dict(on_state))


def test_rollback_knobs_are_fields_at_jax_defaults():
    """The two rollback knobs are fields with JAX's defaults, parsed as
    JAX's ``override`` parses them; what stays in LATER_KNOBS has no
    counterpart."""
    from asyncrl_tpu.utils.config import override as joverride
    from asyncrl_tpu_torch.config import LATER_KNOBS, override

    assert set(LATER_KNOBS) == {"smap_check", "donate_buffers"}
    for knob in ("rollback_bad_windows", "rollback_max_attempts"):
        assert getattr(Config(), knob) == getattr(JConfig(), knob), knob
    kvs = ["rollback_bad_windows=3", "rollback_max_attempts=1"]
    ours, ref = override(Config(), kvs), joverride(JConfig(), kvs)
    assert (ours.rollback_bad_windows, ours.rollback_max_attempts) == (
        ref.rollback_bad_windows, ref.rollback_max_attempts) == (3, 1)


# ------------------------------------------------ e2e: rollback matrix


def _steps(cfg, updates):
    return cfg.num_envs * cfg.unroll_len * updates


def test_rollback_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        make_agent(_sebulba_cfg(rollback_bad_windows=2))


@pytest.mark.parametrize("monitor", [True, False], ids=["health", "no_monitor"])
def test_divergence_quarantines_then_rolls_back_and_recovers(tmp_path, monitor):
    """JAX's rollback matrix in one live run on the port: clean windows bank
    a last good step, a corrupt burst poisons the learner (the guard skips
    those updates), bad window 1 quarantines, bad window 2 restores, and the
    run ends with finite losses and the health verdict ok. The time series
    holds JAX's rollback event keys; the guard-off keys never appear.
    Without a health monitor the policy reads the window's own non-finite
    loss, and the run recovers the same way."""
    health = dict(obs_http_port=-1, health_stall_frac=1.0, health_fps_collapse=0.0)
    cfg = _sebulba_cfg(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        rollback_bad_windows=2, rollback_max_attempts=3, run_dir=str(tmp_path / "run"),
        fault_spec="actor.queue_put:corrupt:1.0:0:max=12,after=16", **(health if monitor else {}),
    )
    agent = make_agent(cfg)
    try:
        assert (agent._obs.monitor is not None) == monitor
        history = agent.train(total_env_steps=_steps(cfg, updates=26))
        last = history[-1]
        assert obs_registry.counter("rollback_restores").value() >= 1
        assert obs_registry.counter("rollback_quarantine").value() >= 1
        assert last.get("nonfinite_skips", 0) > 0  # the guard fired
        assert np.isfinite(last["loss"])
        assert obs_registry.counter("rollback_abort").value() == 0
        if monitor:
            assert agent._obs.monitor.verdict()["status"] == "ok"
        assert not any("nonfinite_skip" in w for w in history)
        assert all("nonfinite_skips" in w for w in history)
    finally:
        agent.close()
    if not monitor:
        return
    events = []
    with open(tmp_path / "run" / "timeseries.jsonl") as f:
        for line in f:
            doc = json.loads(line)
            if doc.get("kind") == "event" and doc["event"].get("event_type") == "rollback":
                events.append(doc["event"])
    assert [e["action"] for e in events].count("rollback") >= 1
    assert all(set(e) == {"event_type", "action", "detail", "detectors", "attempts", "t"}
               for e in events)


def test_rollback_with_rotated_out_last_good_keeps_oldest(tmp_path):
    """Retention rotated the banked last good step out: the rollback keeps
    the oldest retained step, and restores it, rather than emptying the
    directory."""
    cfg = _sebulba_cfg(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                       rollback_bad_windows=2)
    agent = make_agent(cfg)
    try:
        agent.train(total_env_steps=_steps(cfg, updates=6))
        ckpt = agent._ckpt.checkpointer
        steps_before = sorted(ckpt.all_steps())
        assert len(steps_before) >= 2
        agent._rollback.last_good_step = steps_before[0] - 1  # rotated out
        agent._execute_rollback(None)
        assert sorted(ckpt.all_steps()) == [steps_before[0]]
        assert agent.state.update_step == steps_before[0]
    finally:
        agent.close()


def test_rollback_with_no_retained_steps_is_a_noop(tmp_path):
    """A rollback before the first save has nothing to restore: the held
    state goes on, and the directory stays empty."""
    cfg = _sebulba_cfg(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1000,
                       rollback_bad_windows=2)
    agent = make_agent(cfg)
    try:
        assert agent._ckpt.checkpointer.all_steps() == []
        step_before = agent.state.update_step
        agent._execute_rollback(None)  # must not raise
        assert agent.state.update_step == step_before
        assert agent._ckpt.checkpointer.all_steps() == []
    finally:
        agent.close()


def test_rollback_attempts_exhausted_aborts_with_forensics(tmp_path):
    """Corruption with no end re-diverges the run after every rollback: past
    ``rollback_max_attempts`` the run aborts instead of looping."""
    cfg = _sebulba_cfg(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
        rollback_bad_windows=2, rollback_max_attempts=1,
        obs_http_port=-1, health_stall_frac=1.0, health_fps_collapse=0.0,
        run_dir=str(tmp_path / "run"), fault_spec="actor.queue_put:corrupt:1.0:0:after=16",
    )
    agent = make_agent(cfg)
    try:
        with pytest.raises(RuntimeError, match="rollback attempts exhausted"):
            agent.train(total_env_steps=_steps(cfg, updates=200))
        assert obs_registry.counter("rollback_abort").value() == 1
        assert obs_registry.counter("rollback_restores").value() == 1
        assert agent._rollback.attempts == 2
    finally:
        agent.close()


def test_run_state_carries_the_rollback_attempts_across_a_resume(tmp_path):
    """Every checkpoint's ``run_state`` holds the policy's attempts, and a
    ``resume=True`` successor's policy starts from them; a run without the
    rollback writes 0, as JAX's."""
    cfg = _sebulba_cfg(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                       rollback_bad_windows=2, rollback_max_attempts=5)
    agent = make_agent(cfg)
    try:
        agent._rollback.attempts = 3
        agent.train(total_env_steps=_steps(cfg, updates=4))
    finally:
        agent.close()
    run_state = Checkpointer(str(tmp_path / "ck"), create=False).read_meta()["run_state"]
    assert run_state["rollback_attempts"] == 3
    resumed = make_agent(cfg.replace(resume=True))
    try:
        assert resumed._rollback.attempts == 3
        assert resumed._updates == run_state["updates"]
    finally:
        resumed.close()
    plain = make_agent(_sebulba_cfg(checkpoint_dir=str(tmp_path / "ck2"), checkpoint_every=2))
    try:
        assert plain._rollback is None and plain._run_state()["rollback_attempts"] == 0
    finally:
        plain.close()


def test_rollback_window_skips_the_elastic_step(tmp_path):
    """At the window close the rollback is judged first, after the window
    is observed; a window in which it acted never reaches the elastic
    controller, every other window does."""
    cfg = _sebulba_cfg(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                       rollback_bad_windows=2, elastic=True, elastic_max_actors=4)
    agent = make_agent(cfg)
    order = []

    def rollback_step(agg, slab_groups, fragments):
        order.append("rollback")
        return order.count("rollback") % 2 == 1  # acts on windows 1, 3, 5, ...

    agent._rollback_step = rollback_step
    agent._elastic_step = lambda window: order.append("elastic")
    try:
        history = agent.train(total_env_steps=_steps(cfg, updates=12))
    finally:
        agent.close()
    assert len(history) >= 6
    assert order == ["rollback", "rollback", "elastic"] * (len(history) // 2) + (
        ["rollback"] if len(history) % 2 else [])
