"""Normalization layers — the LayerNorm, RMSNorm and GroupNorm of
``repro/models/norms.py``. Params are dicts of tensors (``groupnorm`` takes
its scale and bias directly, as the reference); all compute in f32 and cast
back to the input's dtype."""
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


def rmsnorm_init(d: int, repeat: tuple = ()) -> dict:
    return norm_init("rmsnorm", d, repeat)


def layernorm_init(d: int, repeat: tuple = ()) -> dict:
    return norm_init("layernorm", d, repeat)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(params, x)
    if kind == "layernorm":
        return layernorm(params, x)
    raise ValueError(kind)


def groupnorm(x: torch.Tensor, n_groups: int, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 64e-5) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV6 on its per-head outputs), with the
    population variance."""
    *lead, d = x.shape
    xf = x.to(torch.float32).reshape(*lead, n_groups, d // n_groups)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf.reshape(*lead, d) * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)
