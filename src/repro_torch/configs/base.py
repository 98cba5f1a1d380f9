"""Architecture configuration schema — the port of ``repro/configs/base.py``
(``ArchConfig``, ``LayerCfg``, ``MoECfg``, ``MLACfg``, ``SSMCfg``,
``RWKVCfg``, ``uniform_stages``, ``reduce_for_smoke``): the dense-attention,
recurrent and MLA / MoE families, DeepSeek-V3's multi-token prediction
(``mtp``) included.

The reference module imports ``core/vq`` and through it jax, so the port
keeps its own copy. Field names and defaults match the reference so one
configuration means the same model in both packages. The layer list is
expressed as *stages*: ``(pattern, repeat)`` where pattern is a tuple of
``LayerCfg``; parameters of a stage are stacked over ``repeat``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.vq import VQConfig


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    # capacity factor for fixed-size expert buffers (tokens dropped beyond
    # it); read by the reference's expert-parallel path only
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    q_lora: int
    kv_lora: int
    rope_dim: int
    nope_dim: int
    v_dim: int


@dataclass(frozen=True)
class SSMCfg:
    """Mamba2-style SSD branch (Hymba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    n_ssm_heads: int = 8  # heads for the SSD scalar-decay recurrence


@dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64


@dataclass(frozen=True)
class LayerCfg:
    mixer: str  # 'gqa' | 'mla' | 'hymba' | 'rwkv6'
    ffn: str  # 'swiglu' | 'geglu' | 'gelu' | 'relu' | 'relu2' | 'moe' | 'rwkv_cm'
    window: Optional[int] = None  # sliding-window size; None = global


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stages: Tuple[Tuple[Tuple[LayerCfg, ...], int], ...]
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    pos: str = "rope"  # 'rope' | 'learned' | 'sampled' | 'none'
    rope_theta: float = 10000.0
    max_seq: int = 131072
    pos_pool: int = 0  # for pos == 'sampled'
    attn_softmax: bool = True  # False -> element-wise σ (VQT, paper eq. 1)
    attn_bias: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None
    vqt: Optional[VQConfig] = None
    # multimodal stubs: 'tokens' | 'audio_codes' | 'vlm'
    input_mode: str = "tokens"
    n_codebooks: int = 1  # musicgen: 4 parallel EnCodec streams
    n_patches: int = 256  # vlm: stub patch-embedding count
    mtp: bool = False  # DeepSeek-V3 multi-token-prediction head
    tie_embeddings: bool = False
    # citation for the config values
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def layer_list(self) -> list[LayerCfg]:
        out = []
        for pattern, repeat in self.stages:
            for _ in range(repeat):
                out.extend(pattern)
        return out

    def validate(self) -> "ArchConfig":
        if len(self.layer_list()) != self.n_layers:
            raise ValueError(
                f"{self.name}: stages produce {len(self.layer_list())} layers, "
                f"config says {self.n_layers}")
        return self


def uniform_stages(layer: LayerCfg, n_layers: int):
    return (((layer,), n_layers),)


def reduce_for_smoke(cfg: ArchConfig, *, d_model: int = 256, n_layers: int = 2,
                     n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 512,
                     vocab: int = 512, max_seq: int = 128) -> ArchConfig:
    """Produce a reduced same-family variant (<=2 layers, d<=512, <=4
    experts), exactly as the reference does."""
    changes = dict(
        name=cfg.name + "-smoke",
        d_model=d_model,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=min(n_kv_heads, n_heads),
        d_ff=d_ff,
        vocab=vocab,
        max_seq=max_seq,
        head_dim=None,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=128, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla is not None:
        changes["mla"] = MLACfg(q_lora=64, kv_lora=32, rope_dim=16, nope_dim=48, v_dim=64)
    if cfg.ssm is not None:
        changes["ssm"] = SSMCfg(d_state=16, d_conv=4, expand=2, n_ssm_heads=2)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVCfg(head_dim=32, decay_lora=16)
    if cfg.pos == "sampled":
        changes["pos_pool"] = max_seq * 16
    # Rebuild stages with the same *kind* of pattern but n_layers layers.
    first_layer = cfg.layer_list()[0]
    last_layer = cfg.layer_list()[-1]
    window = 64 if any(l.window for l in cfg.layer_list()) else None
    lo = dataclasses.replace(first_layer, window=window if first_layer.window else None)
    hi = dataclasses.replace(last_layer, window=window if last_layer.window else None)
    changes["stages"] = (((lo,), 1), ((hi,), n_layers - 1)) if n_layers > 1 else (((lo,), 1),)
    return dataclasses.replace(cfg, **changes).validate()
