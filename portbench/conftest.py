"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests -q``): the ``card`` marker, and the fixture that decides,
when a marked test runs, whether a card is there."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run these "
        "on the card with python -m pytest portbench/tests -m card)")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none here)")
    return torch.device("cuda", 0)
