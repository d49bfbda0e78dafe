"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the system under test. Top-level module names
are compared whole: ``asyncrl_tpu_torch`` begins with ``asyncrl_tpu``."""

import ast
import json
import shutil
import subprocess
import sys

from portbench import cells, harness
from portbench.tests.conftest import SMALL

SYSTEM = "asyncrl_tpu_torch"


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    """Every source of the benchmark; ``out/`` holds what runs leave behind."""
    sources = [p for p in cells.PKG.rglob("*.py") if "out" not in p.relative_to(cells.PKG).parts]
    assert len(sources) > 10
    for path in sources:
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_system():
    for path in (cells.PKG / "reference").rglob("*.py"):
        assert SYSTEM not in _imports(path), path


def test_a_dry_run_loads_no_jax():
    """A whole run of the harness on the CPU (the card's check skipped),
    then the process's modules."""
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import run, harness\n"
        f"r = run.run('atari_nature_cnn.b1024', 11, 0.0, True, device='cpu', overrides={SMALL!r})\n"
        "print(json.dumps({'correct': r['correct'], 'found': harness.forbidden_modules()}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(cells.REPO)], capture_output=True,
                         text=True, timeout=600, check=True)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["found"] == []


def test_without_a_card_or_without_the_system_it_prints_no_result(tmp_path):
    run = [sys.executable, "portbench/run.py", "--workload", "atari_impala.b1024",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    here = subprocess.run(run, cwd=cells.REPO, capture_output=True, text=True, timeout=120)
    shutil.copytree(cells.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(cells.REPO / "BENCHMARK.json", tmp_path)
    alone = subprocess.run(run, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    for out in (here, alone):
        assert out.returncode != 0
        assert out.stdout.strip() == ""
