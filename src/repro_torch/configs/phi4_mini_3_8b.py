"""Phi-4-mini 3.8B [arXiv:2412.08905] — mirror of
``repro/configs/phi4_mini_3_8b.py``.

32 layers, d_model 3072, 24 heads (GQA kv=8), d_ff 8192, vocab 200064.
RoPE + SwiGLU + GQA.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="swiglu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab=200064,
        stages=uniform_stages(_LAYER, 32),
        norm="rmsnorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=131072,
        source="arXiv:2412.08905",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
