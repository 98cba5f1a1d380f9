"""Normalization layers — the LayerNorm and RMSNorm of
``repro/models/norms.py`` (``groupnorm`` comes with RWKV, ROADMAP Queue A
item 9b). Params are dicts of tensors; both compute in f32 and cast back to
the input's dtype."""
from __future__ import annotations

import torch


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return out.to(x.dtype)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Population-variance LayerNorm."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return out.to(x.dtype)


def norm_init(kind: str, d: int, repeat: tuple = ()) -> dict:
    """Unit scale (and zero bias for LayerNorm), with leading ``repeat``
    dims (a stage's stacked layers)."""
    if kind == "rmsnorm":
        return {"scale": torch.ones(repeat + (d,))}
    if kind == "layernorm":
        return {"scale": torch.ones(repeat + (d,)), "bias": torch.zeros(repeat + (d,))}
    raise ValueError(kind)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    if kind == "layernorm":
        return layernorm(params, x)
    raise ValueError(kind)
