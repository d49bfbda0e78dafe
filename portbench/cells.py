"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration's file (``portbench/configs/<config>.json``), its traffic
mix (``portbench/traffic/<traffic>.json``), the limits of its comparison
(``portbench/limits/<workload>.json``) and the readers of its per-layer
metrics (``portbench/metrics/<metric>.py``). A new cell, configuration, mix
or metric is new files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
REPO = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # number -> {"limit": ..., the readings it was set from}
    end_to_end: list[dict]  # the metric entries this cell reports
    per_layer: list[dict]
    root: Path

    @property
    def program(self) -> dict:
        """The keyword arguments of the system's ``Config``, as run."""
        return {**self.config["program"], **self.traffic["program"]}

    def reference_module(self, part: str):
        """The plain reference's module for ``part`` ("model", "env" or
        "learner"), as the configuration names it."""
        return importlib.import_module(f"portbench.reference.{self.config['reference'][part]}")

    def model(self):
        """The plain reference's network at the configuration's widths."""
        return self.reference_module("model").Net(self.config)

    def reader(self, metric: str):
        """The ``read(trace)`` function of a per-layer metric."""
        return load_reader(self.root / "portbench" / "metrics" / f"{metric}.py")


def load_reader(path: Path):
    """The ``read`` function of the metric reader at ``path``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load(workload: str, root: Path = REPO) -> Cell:
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[workload]
    config_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=entry["chips"],
        config=json.loads((root / config_file).read_text()),
        traffic=json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root,
    )
