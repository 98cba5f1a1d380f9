"""Multi-head vector-quantization configuration (paper §3 eq. 1, §4).

Only the ``VQConfig`` dataclass of ``repro/core/vq.py``: the port's configs
need it, and the reference module imports jax. Quantization itself lives
in the engine's score-space requantize (``serving/jit_engine.py``).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VQConfig:
    n_heads: int = 2
    codebook_size: int = 64
    commitment_beta: float = 0.25
    # Gumbel-softmax temperature used during training.
    temperature: float = 1.0
