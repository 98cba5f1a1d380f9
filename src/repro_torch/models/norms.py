"""Normalization layers — the LayerNorm subset of ``repro/models/norms.py``
(the VQ-OPT family's only norm). Params are dicts of tensors."""
from __future__ import annotations

import torch


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Population-variance LayerNorm in f32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return out.to(x.dtype)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(params, x)
    raise ValueError(f"the port has no {kind!r} norm yet (model-family slice)")
