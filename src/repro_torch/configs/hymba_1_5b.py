"""Hymba 1.5B [arXiv:2411.13676] — mirror of ``repro/configs/hymba_1_5b.py``.

32 layers, d_model 1600, 25 heads (GQA kv=5, head_dim 64), d_ff 5504,
vocab 32001, ssm_state 16. Parallel attention + mamba heads per layer;
3 global-attention layers (first / middle / last), the rest sliding-window.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, SSMCfg, reduce_for_smoke
from repro_torch.core.vq import VQConfig

_LOCAL = LayerCfg(mixer="hymba", ffn="swiglu", window=1024)
_GLOBAL = LayerCfg(mixer="hymba", ffn="swiglu")


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        # global at layers 0, 15, 31 (first / middle / last, per the paper)
        stages=(
            ((_GLOBAL,), 1),
            ((_LOCAL,), 14),
            ((_GLOBAL,), 1),
            ((_LOCAL,), 15),
            ((_GLOBAL,), 1),
        ),
        head_dim=64,
        norm="rmsnorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=524288,  # SWA + SSM: sub-quadratic, unbounded context
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, n_ssm_heads=25),
        source="arXiv:2411.13676",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
