"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b] — mirror of
``repro/configs/stablelm_1_6b.py``.

24 layers, d_model 2048, 32 heads (kv=32, MHA), d_ff 5632, vocab 100352.
LayerNorm, RoPE (full, simplified from the model card's 25% partial rotary).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="swiglu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
        stages=uniform_stages(_LAYER, 24),
        norm="layernorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=4096,
        source="hf:stabilityai/stablelm-2-1_6b",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
