"""Gemma-3 12B [hf:google/gemma-3-1b-pt family, scaled per assignment] —
mirror of ``repro/configs/gemma3_12b.py``.

48 layers, d_model 3840, 16 heads (GQA kv=8, head_dim 256), d_ff 15360,
vocab 262144. 5 local (sliding-window 1024) : 1 global layer pattern, 128k
context.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke
from repro_torch.core.vq import VQConfig

_LOCAL = LayerCfg(mixer="gqa", ffn="geglu", window=1024)
_GLOBAL = LayerCfg(mixer="gqa", ffn="geglu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_ff=15360,
        vocab=262144,
        # 5:1 local:global, 8 repeats of the 6-layer pattern = 48 layers
        stages=(((_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL), 8),),
        head_dim=256,
        norm="rmsnorm",
        pos="rope",
        rope_theta=1000000.0,
        max_seq=131072,
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
