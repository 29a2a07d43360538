"""The benchmark's CPU tests: its folder and the checkout on the path;
the card, where a test needs one, decided inside a fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
for p in (str(BENCH), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
