"""DeepSeek-V2 236B [arXiv:2405.04434] — mirror of
``repro/configs/deepseek_v2_236b.py``.

60 layers, d_model 5120, 128 attention heads (MLA: kv_lora=512, rope 64,
nope 128, v 128, q_lora 1536), MoE with 2 shared + 160 routed experts top-6,
expert d_ff 1536 (the assignment's d_ff), first layer dense FFN (8x expert
width = 12288), vocab 102400.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, MLACfg, MoECfg, reduce_for_smoke
from repro_torch.core.vq import VQConfig

_DENSE = LayerCfg(mixer="mla", ffn="swiglu")
_MOE = LayerCfg(mixer="mla", ffn="moe")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # dense (first) layer FFN = 8 x expert width
        vocab=102400,
        stages=(((_DENSE,), 1), ((_MOE,), 59)),
        head_dim=192,  # nope 128 + rope 64
        norm="rmsnorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=131072,
        moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
        mla=MLACfg(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
        source="arXiv:2405.04434",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
