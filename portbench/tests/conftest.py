"""The ``card`` fixture: card-only tests take it and are marked ``cuda``;
whether a card is there is decided inside the fixture, when the test runs,
never when a module is imported."""
from __future__ import annotations

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's CUDA kernels and TF32)")
    return torch.device("cuda")
