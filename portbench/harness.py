"""The steps of a run that the command and the calibration share: the
system built with the seed's weights, its first updates recorded through
the window's own call, the timed window, and the plain reference's
comparison of the recorded updates.

The system under test is ``asyncrl_tpu_torch``: ``make_agent(config)`` ->
``Trainer.train`` -> ``Learner.update``. The benchmark hands it a
``Config``, the weights and nothing else.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import torch

from portbench import hooks, judge
from portbench import weights as weight_maker
from portbench.cells import Cell

# Top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the system was ported from (compared whole, so the
# system's own name, which begins with the latter's, does not match).
FORBIDDEN = ("jax", "jaxlib", "flax", "asyncrl_tpu")
CHECKED_UPDATES = 3


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def seeds(seed: int) -> tuple[int, int]:
    """(env seed, weight seed) of the run seed: two streams that never meet."""
    return (2 * seed) % 2 ** 63, (2 * seed + 1) % 2 ** 63


def program_config(cell: Cell, env_seed: int, device: str, **overrides):
    from asyncrl_tpu_torch.config import Config

    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.program.items()}
    return Config(**{**kwargs, "seed": env_seed, "device": device, **overrides})


def steps_per_call(config) -> int:
    return config.batch_steps_per_update * config.updates_per_call


def reference_weights(cell: Cell, seed: int, device, num_actions: int) -> dict:
    specs = cell.model().param_specs(num_actions)
    return weight_maker.make(specs, seeds(seed)[1], device)


def build(cell: Cell, seed: int, device: str, **overrides):
    """``(agent, weights)``: the system's trainer for the cell, its learner
    and actor weights the seed's."""
    from asyncrl_tpu_torch import make_agent

    agent = make_agent(program_config(cell, seeds(seed)[0], device, **overrides))
    weights = reference_weights(cell, seed, agent.device, agent.env.spec.num_actions)
    shapes = {name: tuple(p.shape) for name, p in agent.state.params.named_parameters()}
    wanted = {name: tuple(w.shape) for name, w in weights.items()}
    if shapes != wanted:
        differ = sorted(n for n in shapes.keys() | wanted.keys() if shapes.get(n) != wanted.get(n))
        raise ValueError(f"the system's parameters are not the reference's: "
                         f"{[(n, shapes.get(n), wanted.get(n)) for n in differ]}")
    with torch.no_grad():
        for module in {id(m): m for m in (agent.state.params, agent.state.actor_params)}.values():
            for name, p in module.named_parameters():
                p.copy_(weights[name])
    return agent, weights


def checked_updates(agent, n: int = CHECKED_UPDATES) -> dict:
    """The first ``n`` update calls, through ``Trainer.train`` as the window
    makes them, recorded for the comparison."""
    recorder = hooks.Recorder(agent.learner, n).bind()
    try:
        agent.train(total_env_steps=agent.env_steps + n * steps_per_call(agent.config))
    finally:
        recorder.unbind()
    return recorder.record


@dataclasses.dataclass
class Window:
    env_steps: int = 0
    seconds: float = 0.0
    updates: int = 0
    failed: int = 0
    call_seconds: list = dataclasses.field(default_factory=list)


def timed_window(agent, seconds: float) -> Window:
    """Whole ``Trainer.train`` calls of ``log_every`` update calls (one drain
    each, as a user runs them) back to back, until ``seconds`` have passed;
    the window closes on the device read of the last call's drain. An update
    counts as failed when the loss or gradient norm of its drain is not
    finite."""
    cfg = agent.config
    call_steps = cfg.log_every * steps_per_call(agent.config)
    out = Window()
    start = time.perf_counter()
    while True:
        history = agent.train(total_env_steps=agent.env_steps + call_steps)
        updates = cfg.log_every * cfg.updates_per_call
        if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
            out.failed += updates
        out.env_steps += call_steps
        out.updates += updates
        out.call_seconds.append(time.perf_counter() - start - out.seconds)
        out.seconds = time.perf_counter() - start
        if out.seconds >= seconds:
            return out


def free_device() -> None:
    """Return the device memory of what is no longer referenced (the caller
    drops the system's trainer first; the reference runs after it)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(cell: Cell, seed: int, weights: dict, device, record: dict | None = None,
              precision: str = "f32") -> dict:
    """The plain reference's run over the cell's first updates: following
    ``record``, or acting itself without one."""
    program = cell.program
    env = cell.reference_module("env").make(program)
    return cell.reference_module("learner").run(
        cell.model(), env, program, weights, seeds(seed)[0],
        CHECKED_UPDATES, device, precision=precision, record=record)


def compare(cell: Cell, seed: int, weights: dict, record: dict, device) -> dict:
    """The numbers of ``judge`` for a recorded run."""
    ref = reference(cell, seed, weights, device, record=record)
    initial_fragments = min(CHECKED_UPDATES, cell.program["actor_staleness"])
    return judge.numbers(record, ref, weights, initial_fragments)
