"""Settings of the benchmark's own tests (`python -m pytest h100_bench/tests`).

Tests that need a CUDA device carry the `cuda` marker and take the `card`
fixture, which skips them where there is none; the decision is made when
the test runs, never when a module is imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return torch.device("cuda", 0)
