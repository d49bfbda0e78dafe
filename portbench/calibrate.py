"""The readings that the limits of a cell's comparison are set from, made
on the card at the cell's own size, in one process: the system's first
updates on each seed of ``--seeds``; the control (the plain reference one
precision step below the configuration's, acting in the system's place) on
each of ``--control-seeds``; and each planted fault of ``faults.py`` but
``unchanged`` (which reads 1 by construction) on each of ``--fault-seeds``.
No window is timed. One JSON line a reading on standard output.

    python3 portbench/calibrate.py --workload atari_impala.b1024 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def reading(cell, seed: int, device: str, fault: str | None = None) -> dict:
    """The judged numbers of the system's first updates, under ``fault``."""
    from portbench import faults, harness

    start = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        agent, weights = harness.build(cell, seed, device)
        record = harness.checked_updates(agent)
    del agent
    harness.free_device()
    numbers = harness.compare(cell, seed, weights, record, device)
    return {"kind": fault or "program", "seed": seed, "numbers": numbers,
            "seconds": time.perf_counter() - start}


def control_reading(cell, seed: int, device: str) -> dict:
    """The judged numbers of the control acting in the system's place."""
    from portbench import harness

    start = time.perf_counter()
    env = cell.reference_module("env").make(cell.program)
    weights = harness.reference_weights(cell, seed, device, env.num_actions)
    record = harness.reference(cell, seed, weights, device, precision="control")["record"]
    return {"kind": "control", "seed": seed,
            "numbers": harness.compare(cell, seed, weights, record, device),
            "seconds": time.perf_counter() - start}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, default=[])
    parser.add_argument("--control-seeds", type=_ints, default=[])
    parser.add_argument("--fault-seeds", type=_ints, default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import cells, faults

    cell = cells.load(args.workload)
    jobs = [(reading, seed, None) for seed in args.seeds]
    jobs += [(control_reading, seed, None) for seed in args.control_seeds]
    jobs += [(reading, seed, fault) for fault in faults.FAULTS if fault != "unchanged"
             for seed in args.fault_seeds]
    for fn, seed, fault in jobs:
        row = fn(cell, seed, "cuda", fault) if fault else fn(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
