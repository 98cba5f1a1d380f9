"""Token and absolute positional embeddings (learned, and the paper's
sampled positions) — ``embed_tokens`` of ``repro/models/embedding.py`` for
single-codebook tokens."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig


def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: [b, n] ints; positions: [b, n] absolute ids (required for
    ``pos`` in ("learned", "sampled")). Returns [b, n, d]."""
    x = params["tok"][tokens.long()]
    if cfg.pos in ("learned", "sampled"):
        if positions is None:
            raise ValueError(f"pos={cfg.pos} needs explicit position ids")
        x = x + params["pos"][positions.long()]
    return x
