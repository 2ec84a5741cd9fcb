"""CPU tests of the benchmark. Tests marked ``card`` need an NVIDIA GPU and
skip without one; each decides inside itself.

    python -m pytest mdbench/tests -q            # here, on the CPU
    python -m pytest mdbench/tests -q -m card    # on a machine with the card
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (this is a check of the card)")
    return torch.device("cuda:0")
