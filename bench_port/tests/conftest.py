"""The benchmark's tests: CPU ones at toy sizes, and card ones marked
`card`, which skip without a CUDA card (decided inside a fixture).

    python -m pytest bench_port/tests -q              # here: the card tests skip
    python -m pytest bench_port/tests -q -m card      # on the card
"""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
