"""The port's model layers (``repro/models/``). ``normal`` is the seeded
draw every layer's init uses; with no generator it makes ``meta``
stand-ins."""
from __future__ import annotations

import torch


def draw_device(gen) -> torch.device:
    """Where a draw from ``gen`` lands: the generator's device, or ``meta``
    (shapes only, nothing drawn) for None — the dry run's stand-ins."""
    return torch.device("meta") if gen is None else gen.device


def normal(gen, shape, scale: float) -> torch.Tensor:
    """Standard normals times ``scale``, drawn on the generator's device
    (``draw_device``)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=draw_device(gen)).mul_(scale)
