"""Token and absolute positional embeddings (learned, and the paper's
sampled positions), multi-codebook audio tokens and the vision prefix —
``embedding_init``, ``embed_tokens`` and ``merge_vision`` of
``repro/models/embedding.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import normal


def embedding_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """``tok`` [vocab, d] ([cb, vocab, d] with codebooks), ``pos`` (the
    ``learned`` table [max_seq, d] or the ``sampled`` pool [pos_pool, d])
    and the VLM's ``vis_proj`` [d, d], drawn from ``gen`` in that order at
    the reference's scales."""
    d, cb = cfg.d_model, cfg.n_codebooks
    p = {"tok": normal(gen, (cb, cfg.vocab, d) if cb > 1 else (cfg.vocab, d), 0.02)}
    if cfg.pos == "sampled":
        p["pos"] = normal(gen, (cfg.pos_pool or cfg.max_seq * 100, d), 0.02)
    elif cfg.pos == "learned":
        p["pos"] = normal(gen, (cfg.max_seq, d), 0.02)
    elif cfg.pos not in ("rope", "none"):
        raise ValueError(f"unknown pos={cfg.pos!r}")
    if cfg.input_mode == "vlm":
        p["vis_proj"] = normal(gen, (d, d), d ** -0.5)
    return p


def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: [b, n] ints (audio: [b, n, n_codebooks], summed over the
    codebooks' tables ``tok`` [cb, vocab, d]); positions: [b, n] absolute
    ids (required for ``pos`` in ("learned", "sampled")). Returns
    [b, n, d]."""
    if cfg.n_codebooks > 1:
        if tokens.dim() != 3:
            raise ValueError("audio tokens must be [b, n, n_codebooks]")
        x = sum(params["tok"][c][tokens[..., c].long()] for c in range(cfg.n_codebooks))
    else:
        x = params["tok"][tokens.long()]
    if cfg.pos in ("learned", "sampled"):
        if positions is None:
            raise ValueError(f"pos={cfg.pos} needs explicit position ids")
        x = x + params["pos"][positions.long()]
    return x


def merge_vision(params: dict, patch_embeds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Prefix the (stub) vision patch embeddings [b, n_patches, d], projected
    by ``vis_proj``, to the token stream [b, n, d] (VLM)."""
    vis = patch_embeds @ params["vis_proj"]
    return torch.cat([vis.to(x.dtype), x], dim=1)
