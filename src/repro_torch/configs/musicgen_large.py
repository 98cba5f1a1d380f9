"""MusicGen-large decoder [arXiv:2306.05284] — mirror of
``repro/configs/musicgen_large.py``.

48 layers, d_model 2048, 32 heads (kv=32), d_ff 8192, vocab 2048 per EnCodec
codebook, 4 codebooks (delay interleaving pattern). Decoder-only over EnCodec
tokens; the EnCodec frontend is a stub: callers pass token ids [b, n, 4].
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="gelu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        stages=uniform_stages(_LAYER, 48),
        norm="layernorm",
        pos="learned",
        max_seq=32768,
        attn_bias=True,
        n_codebooks=4,
        source="arXiv:2306.05284",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(
            cfg, attn_softmax=False, vqt=VQConfig(n_heads=2), pos="sampled",
            pos_pool=cfg.max_seq * 4,
        )
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
