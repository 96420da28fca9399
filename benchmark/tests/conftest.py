"""The benchmark's own tests (``python -m pytest benchmark/tests``).

Tests marked ``chip`` need a CUDA card and skip without one; on the card
they run with ``python -m pytest benchmark/tests -m chip``."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import env  # noqa: E402

env.prepare()


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)
