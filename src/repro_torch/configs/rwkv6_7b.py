"""RWKV-6 "Finch" 7B [arXiv:2404.05892] — mirror of ``repro/configs/rwkv6_7b.py``.

32 layers, d_model 4096 (attention-free: 64 WKV heads of dim 64), channel-mix
d_ff 14336, vocab 65536. Data-dependent per-channel decay via decay-LoRA.

VQT inapplicability: the WKV recurrence makes every position depend on the
entire prefix, so there is no row/column-sparse attention patch; ``vqt`` is
accepted for registry uniformity and ignored, as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig, LayerCfg, RWKVCfg, reduce_for_smoke, uniform_stages,
)

_LAYER = LayerCfg(mixer="rwkv6", ffn="rwkv_cm")


def config(vqt: bool = False) -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,
        n_kv_heads=64,
        d_ff=14336,
        vocab=65536,
        stages=uniform_stages(_LAYER, 32),
        norm="layernorm",
        pos="none",
        max_seq=524288,  # O(1) state: unbounded context
        rwkv=RWKVCfg(head_dim=64, decay_lora=64),
        source="arXiv:2404.05892",
    ).validate()


def smoke_config(vqt: bool = False) -> ArchConfig:
    return reduce_for_smoke(config())
