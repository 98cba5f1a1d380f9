"""VQ-OPT-125M — the paper's own model (OPT-125M + VQT, paper §4).

Mirror of ``repro/configs/vq_opt_125m.py``. OPT-125M base [Zhang et al.
2022]: 12 layers, d_model 768, 12 heads, d_ff 3072, vocab 50272, LayerNorm,
learned positions, GELU FFN, biases. VQT modifications (paper §3):
element-wise GELU attention (no softmax), multi-head VQ (h=2, codebook 64)
on attention outputs, sampled absolute positional embeddings drawn from a
pool 100x the max sequence length.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    ArchConfig, LayerCfg, reduce_for_smoke, uniform_stages,
)
from repro_torch.core.vq import VQConfig

_LAYER = LayerCfg(mixer="gqa", ffn="gelu")

MAX_SEQ = 2048


def config(vqt: bool = True, vq_heads: int = 2) -> ArchConfig:
    cfg = ArchConfig(
        name="vq-opt-125m" if vqt else "opt-125m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=50272,
        stages=uniform_stages(_LAYER, 12),
        norm="layernorm",
        pos="learned",
        max_seq=MAX_SEQ,
        attn_bias=True,
        tie_embeddings=True,
        source="arXiv:2205.01068 + paper §4",
    ).validate()
    if vqt:
        cfg = dataclasses.replace(
            cfg,
            attn_softmax=False,
            vqt=VQConfig(n_heads=vq_heads, codebook_size=64),
            pos="sampled",
            pos_pool=100 * MAX_SEQ,
        )
    return cfg


def smoke_config(vqt: bool = True) -> ArchConfig:
    return reduce_for_smoke(config(vqt), n_kv_heads=4)  # OPT is MHA
