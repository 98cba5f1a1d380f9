"""Input stand-ins for every (architecture × input shape) —
``repro/launch/specs.py`` on the port.

The reference returns ``jax.ShapeDtypeStruct``s for ``jax.jit(...).lower()``;
the port returns tensors on the ``meta`` device, which carry a shape and a
dtype and allocate nothing. Shapes are the reference's. Dtypes are those
the port's forward takes: int32 tokens and positions (the reference's
too), and f32 ``patch_embeds`` where the reference declares bf16 (the port
runs f32 throughout). The modality carve-out (audio / VLM frontends) is
implemented here: ``input_specs`` provides precomputed patch embeddings of
the right shape for the stubbed encoders.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic decode; DESIGN.md §4)
LONG_CONTEXT_OK = {"gemma3-12b", "h2o-danube-1.8b", "hymba-1.5b", "rwkv6-7b"}


def shape_supported(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: long_500k requires sub-quadratic decode"
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """Model inputs for forward/train at this shape (decode handled by
    ``decode_token_specs``, since it also needs caches)."""
    b, n = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.input_mode == "vlm":
        n_text = n - cfg.n_patches
        out["tokens"] = sds((b, n_text), torch.int32)
        out["patch_embeds"] = sds((b, cfg.n_patches, cfg.d_model), torch.float32)
    elif cfg.n_codebooks > 1:
        out["tokens"] = sds((b, n, cfg.n_codebooks), torch.int32)
    else:
        out["tokens"] = sds((b, n), torch.int32)
    if cfg.pos in ("learned", "sampled"):
        out["positions"] = sds(out["tokens"].shape[:2], torch.int32)
    return out


def decode_token_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    b = shape.global_batch
    if cfg.n_codebooks > 1:
        tok = sds((b, 1, cfg.n_codebooks), torch.int32)
    else:
        tok = sds((b, 1), torch.int32)
    return {"tokens": tok, "positions": sds((b, 1), torch.int32)}
