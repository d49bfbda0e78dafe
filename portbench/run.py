"""The benchmark of ``asyncrl_tpu_torch``, the PyTorch and CUDA port: one
cell, one run.

    python3 portbench/run.py --workload atari_impala.b1024 --seed 7 --seconds 25 --trace 0

from the root of a checkout, on a machine with the cards the cell asks for
(``BENCHMARK.json`` lists the cells). It builds the trainer with weights
made on the card from ``--seed``, runs its first three update calls and
records them, times whole ``Trainer.train`` calls for ``--seconds``, and
then has the plain reference (``portbench/reference/``) follow the three
recorded updates to decide ``correct``. The last line of standard output is
the result, one JSON object; the compared numbers and their limits are the
last lines of standard error. ``--trace 1`` reports the per-layer metrics in
place of the end-to-end ones: CUDA events around every update of the window,
then a short profiled stretch. The harness's tests run on the CPU:

    python -m pytest portbench/tests -q

and its tests that need a card, on the card: ``python -m pytest portbench/tests -m card``.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "out" / "cache"
PROFILED_CALLS = 2


def _pin_caches() -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def power_limit_w(index: int = 0):
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Trace:
    """What the per-layer readers read (``portbench/metrics/<name>.py``)."""

    def __init__(self, cell, config, window, updates, profile, flops_per_env_step, peaks):
        self.cell, self.config, self.window = cell, config, window
        self.updates, self.profile = updates, profile
        self.flops_per_env_step, self.peaks = flops_per_env_step, peaks


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict | None = None, root: Path = ROOT) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``overrides`` change the cell's traffic (the tests' small sizes);
    ``root`` holds ``BENCHMARK.json`` and the cell's files."""
    import torch

    from portbench import cells, harness, hooks, judge

    cell = cells.load(workload, root=root)
    if overrides:
        cell.traffic = {**cell.traffic, "program": {**cell.traffic["program"], **overrides}}
    on_card = device == "cuda"
    agent, weights = harness.build(cell, seed, device)
    record = harness.checked_updates(agent)
    timer = hooks.Timer(agent.learner).bind() if trace and on_card else None
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - PROCESS_START
    window = harness.timed_window(agent, seconds)
    print(f"window: {window.updates} updates in {window.seconds:.3f} s, calls of "
          + " ".join(f"{s:.3f}" for s in window.call_seconds) + " s", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")
    result = {"correct": False, "attempted": window.updates, "failed": window.failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    if trace:
        metrics = _per_layer(cell, agent, window, timer, device_info, result)
        timer = None
    else:
        # A metric split by cells (``env_steps_per_s.host_paced``) is its
        # quantity's, named before the first dot.
        values = {"env_steps_per_s": window.env_steps / window.seconds, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if on_card:
        device_info["power_limit_w"] = power_limit_w(torch.cuda.current_device())
    del agent
    harness.free_device()
    numbers = harness.compare(cell, seed, weights, record, device)
    correct, checks = judge.decide(numbers, cell.limits["checks"])
    result.update(correct=correct, metrics=metrics, device=device_info)
    result["checks"] = checks  # the last key of the line
    return result


def _per_layer(cell, agent, window, timer, device_info: dict, result: dict) -> dict:
    """The cell's per-layer metrics: the window's CUDA events, then (on the
    card) a profiled stretch of update calls for the device's readers, the
    breakdown, ``busy_s`` and ``window_s``."""
    from portbench import flops, harness, hooks, profiling

    config = agent.config
    updates, profile = [], None
    if timer is not None:
        updates = timer.read()
        timer.unbind()
    if device_info["platform"] == "gpu":
        call = harness.steps_per_call(config)
        profile = profiling.device_stretch(
            lambda: agent.train(total_env_steps=agent.env_steps + PROFILED_CALLS * call))
        profile["updates"] = PROFILED_CALLS * config.updates_per_call
        labels = hooks.Labels(agent.learner).bind()
        try:
            idle_gaps = profiling.host_stretch(
                lambda: agent.train(total_env_steps=agent.env_steps + call))
        finally:
            labels.unbind()
        device_info.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = {"device_ops": profiling.top_ops(profile["events"]),
                               "idle_gaps": idle_gaps}
    layers = cell.model().layers(agent.env.spec.num_actions)
    data = Trace(cell, config, window, updates, profile,
                 flops.flops_per_env_step(layers, config.unroll_len),
                 flops.peaks(device_info["kind"]))
    metrics = {}
    for entry in cell.per_layer:
        value = cell.reader(entry["name"])(data)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import cells, harness

    chips = cells.load(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
