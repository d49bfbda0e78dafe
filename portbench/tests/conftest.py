"""The harness's tests: on the CPU, at small sizes. Those that need a card
carry the ``card`` marker and its fixture, which skips them where there is
none: ``python -m pytest portbench/tests -m card`` on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The cells' traffic cut to what the CPU runs in seconds: widths unchanged.
SMALL = {"num_envs": 16, "unroll_len": 8, "log_every": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
