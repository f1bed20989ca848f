"""The benchmark's own tests: ``python -m pytest gpubench/tests -q`` (CPU;
the card's tests, marked ``gpu``, skip without one and run on the card
with ``python -m pytest gpubench/tests -m gpu -q``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is there (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
