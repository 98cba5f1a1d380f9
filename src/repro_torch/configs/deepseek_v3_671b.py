"""DeepSeek-V3 671B [arXiv:2412.19437] — mirror of
``repro/configs/deepseek_v3_671b.py``.

61 layers, d_model 7168, 128 heads (MLA kv_lora=512), MoE 1 shared + 256
routed top-8, expert d_ff 2048 (assignment's d_ff), first 3 layers dense
(d_ff 18432 = 9 x expert width), vocab 129280, multi-token prediction head.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, MLACfg, MoECfg, reduce_for_smoke
from repro_torch.core.vq import VQConfig

_DENSE = LayerCfg(mixer="mla", ffn="swiglu")
_MOE = LayerCfg(mixer="mla", ffn="moe")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,  # dense (first-3) layer FFN = 9 x expert width
        vocab=129280,
        stages=(((_DENSE,), 3), ((_MOE,), 58)),
        head_dim=192,
        norm="rmsnorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=131072,
        moe=MoECfg(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
        mla=MLACfg(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
        mtp=True,
        source="arXiv:2412.19437",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
