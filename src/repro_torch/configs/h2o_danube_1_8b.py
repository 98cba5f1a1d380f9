"""H2O-Danube 1.8B [arXiv:2401.16818] — mirror of
``repro/configs/h2o_danube_1_8b.py``.

24 layers, d_model 2560, 32 heads (GQA kv=8), d_ff 6912, vocab 32000.
Llama+Mistral mix with sliding-window attention (window 4096).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="swiglu", window=4096)


def config(vqt: bool = False) -> ArchConfig:
    cfg = ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        stages=uniform_stages(_LAYER, 24),
        norm="rmsnorm",
        pos="rope",
        rope_theta=10000.0,
        max_seq=524288,  # SWA: cache is window-bounded, context unbounded
        source="arXiv:2401.16818",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(cfg, attn_softmax=False, vqt=VQConfig(n_heads=2))
    return cfg


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config(vqt))
