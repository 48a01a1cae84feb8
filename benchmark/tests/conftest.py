"""The benchmark's own tests: `python3 -m pytest benchmark/tests` (CPU,
~1 min); the card-marked ones skip without a card and run on it."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
