"""A configuration, a traffic mix and a per-layer metric come in as new
files and new entries of ``BENCHMARK.json``, with no edit to a file the
benchmark already has."""

import json
import shutil

import pytest

from portbench import cells, harness, run
from portbench.tests.conftest import SMALL


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(cells.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(cells.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _files(tmp_path)
    pkg = tmp_path / "portbench"

    config = json.loads((pkg / "configs" / "atari_impala.json").read_text())
    config["program"]["channels"] = [32, 64, 64]
    (pkg / "configs" / "wider_impala.json").write_text(json.dumps(config))
    traffic = json.loads((pkg / "traffic" / "anakin_b1024_t32.json").read_text())
    traffic["program"]["num_envs"] = 512
    (pkg / "traffic" / "anakin_b512_t32.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "wider_impala.b512.json").write_text(
        (pkg / "limits" / "atari_impala.b1024.json").read_text())
    (pkg / "metrics" / "envs_a_update.py").write_text(
        "def read(trace):\n    return float(trace.config.num_envs)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wider_impala", "source": "https://arxiv.org/abs/1802.01561",
                             "file": "portbench/configs/wider_impala.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "wider_impala.b512", "config": "wider_impala",
                               "traffic": "anakin_b512_t32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "envs_a_update", "unit": "envs", "better": "higher",
                               "source": "program_counter", "layer": "rollout",
                               "moves": "env_steps_per_s", "workloads": ["wider_impala.b512"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("wider_impala.b512", root=tmp_path)
    assert cell.program["channels"] == [32, 64, 64]
    assert cell.program["num_envs"] == 512
    assert [m["name"] for m in cell.per_layer] == ["envs_a_update"]
    # The new cell runs whole, at its new widths (traffic cut to the CPU's
    # size): the system and the reference each at channels (32, 64, 64).
    result = run.run("wider_impala.b512", 31, 0.0, True, device="cpu", overrides=SMALL,
                     root=tmp_path)
    assert result["metrics"] == {"envs_a_update": {"value": float(SMALL["num_envs"]),
                                                   "unit": "envs"}}
    assert result["correct"], result["checks"]
    old = cells.load("atari_impala.b1024", root=tmp_path)
    assert "envs_a_update" not in [m["name"] for m in old.per_layer]
    after = _files(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_widths_the_system_does_not_run_are_refused():
    """The reference's widths are the configuration's; where the system
    builds others, the run stops before any update."""
    cell = cells.load("atari_nature_cnn.b1024")
    cell.config = {**cell.config, "widths": {**cell.config["widths"], "features": 256}}
    cell.traffic = {**cell.traffic, "program": {**cell.traffic["program"], **SMALL}}
    with pytest.raises(ValueError, match="torso.dense.weight"):
        harness.build(cell, 1, "cpu")
