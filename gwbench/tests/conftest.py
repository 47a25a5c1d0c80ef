"""The benchmark's own tests: ``python -m pytest gwbench/tests`` from the
root of the repository, here on the CPU; the tests marked ``cuda`` run only
where there is a card (``python -m pytest gwbench/tests -m cuda``)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit; skips "
        "without one")


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
