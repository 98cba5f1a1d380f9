"""InternVL2-1B language backbone (Qwen2-0.5B) [arXiv:2404.16821] — mirror
of ``repro/configs/internvl2_1b.py``.

24 layers, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151655.
The InternViT vision encoder is a stub: callers pass precomputed patch
embeddings [b, n_patches, d_model]; the port implements the projector and
the language decoder that consumes them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="swiglu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151655,
        stages=uniform_stages(_LAYER, 24),
        norm="rmsnorm",
        pos="rope",
        rope_theta=1000000.0,
        max_seq=32768,
        attn_bias=True,  # Qwen2 QKV bias
        input_mode="vlm",
        n_patches=256,
        tie_embeddings=True,
        source="arXiv:2404.16821",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
