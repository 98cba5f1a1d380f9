"""The port's model layers (``repro/models/``). ``normal`` is the seeded
draw every layer's init uses."""
from __future__ import annotations

import torch


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Standard normals times ``scale``, drawn on the generator's device."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).mul_(scale)
