"""The benchmark's own tests (run as ``python -m pytest benchmark/tests``;
the repository's tier-1 command does not collect them).  Tests marked
``cuda`` need an NVIDIA card and run on the GPU machine; they decide inside
the ``card`` fixture that there is none, and skip."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
