"""Tests of the benchmark itself: ``python -m pytest perfbench/tests -q``.

Tests that need the CUDA card carry the ``card`` marker and skip here with
a reason; whether there is a card is decided inside the ``card`` fixture,
never while a module is imported. On the card:
``python -m pytest perfbench/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the program's kernels have no CPU path to time or check here")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def root():
    return ROOT
