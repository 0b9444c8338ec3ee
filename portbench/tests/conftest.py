"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`card` that run only where a CUDA card is visible (run them on the card
with `python3 -m pytest portbench/tests -m card`)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return torch.device("cuda:0")


@pytest.fixture
def root():
    return ROOT
