"""RWKV-6 "Finch" mixer (arXiv:2404.05892) — the port of
``repro/models/rwkv6.py``: attention-free time-mix with data-dependent
per-channel decay, plus the RWKV channel-mix FFN.

Time-mix (per head, state S ∈ R^{dk×dv}):

    wkv_t = (r_t) · S_{t-1} + (r_t ⊙ u ⊙ k_t) · v_t
    S_t   = diag(λ_t) S_{t-1} + k_t v_tᵀ ,   λ_t = exp(-exp(w_t))

where w_t comes from a low-rank ("decay LoRA") projection of the
token-shifted input. The recurrence is the ``mamba_style=False`` case of
``models.linear_scan``. Token shift: every projection sees lerp(x_t,
x_{t-1}, μ); decode carries the previous token's input in its state.

Parameter layout (each leaf with the stage's leading repeat dims):
time-mix ``mu [5, d]``, ``w_r / w_k / w_v / w_g / w_o [d, d]``, ``w0 [d]``,
``w_dec_a [d, lora]``, ``w_dec_b [lora, d]``, ``u [d]``, ``gn_scale /
gn_bias [d]``; channel-mix ``mu [2, d]``, ``w_k [d, d_ff]``, ``w_v [d_ff,
d]``, ``w_r [d, d]``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.models import draw_device, normal
from repro_torch.models.linear_scan import CHUNK, lin_attn_chunked, lin_attn_decode_step
from repro_torch.models.norms import groupnorm


def _uniform(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=draw_device(gen)).mul_(scale)


def rwkv_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg, r: tuple = ()) -> dict:
    """Time-mix parameters with leading dims ``r``, at the reference's
    scales (its draws come from ``jax.random``, these from ``gen``)."""
    d, lora = cfg.d_model, cfg.rwkv.decay_lora
    s = d ** -0.5
    return {
        "mu": _uniform(gen, r + (5, d), 0.5),  # token-shift lerp of r/k/v/w/g
        "w_r": normal(gen, r + (d, d), s),
        "w_k": normal(gen, r + (d, d), s),
        "w_v": normal(gen, r + (d, d), s),
        "w_g": normal(gen, r + (d, d), s),
        "w0": torch.full(r + (d,), -0.6),  # decay: w0 + lora(x_w)
        "w_dec_a": normal(gen, r + (d, lora), s),
        "w_dec_b": normal(gen, r + (lora, d), lora ** -0.5 * 0.1),
        "u": normal(gen, r + (d,), 0.3),  # per-channel bonus
        "w_o": normal(gen, r + (d, d), s),
        "gn_scale": torch.ones(r + (d,)),
        "gn_bias": torch.zeros(r + (d,)),
    }


def cm_init(gen: torch.Generator, cfg: ArchConfig, r: tuple = ()) -> dict:
    """Channel-mix FFN parameters with leading dims ``r``. (The reference
    draws ``mu`` and ``w_r`` from one key; only the layout matters here.)"""
    d, d_ff = cfg.d_model, cfg.d_ff
    return {
        "mu": _uniform(gen, r + (2, d), 0.5),
        "w_k": normal(gen, r + (d, d_ff), d ** -0.5),
        "w_v": normal(gen, r + (d_ff, d), d_ff ** -0.5),
        "w_r": normal(gen, r + (d, d), d ** -0.5),
    }


def _token_shift(x: torch.Tensor, x_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The x_{t-1} stream: x [b, n, d] shifted right by one along time,
    ``x_last`` [b, d] (or zeros) in front."""
    pad = torch.zeros_like(x[:, :1]) if x_last is None else x_last[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lora(x, w_a, w_b):
    return torch.tanh(x @ w_a) @ w_b


def _time_mix_ops(params: dict, cfg: ArchConfig, x: torch.Tensor, x_prev: torch.Tensor):
    """r, k, v, logw as [b, H, n, dh], the gate g [b, n, d] and u [H, dh]."""
    d, dh = cfg.d_model, cfg.rwkv.head_dim
    H = d // dh
    mu = params["mu"]  # [5, d]: lerp(x, x_prev, mu_i) for the r/k/v/w/g streams
    xr, xk, xv, xw, xg = (x + (x_prev - x) * mu[i] for i in range(5))
    rr = xr @ params["w_r"]
    kk = xk @ params["w_k"]
    vv = xv @ params["w_v"]
    gg = F.silu(xg @ params["w_g"])
    f32 = lambda a: a.to(torch.float32)  # noqa: E731
    logw = -torch.exp(params["w0"] + _lora(f32(xw), f32(params["w_dec_a"]),
                                           f32(params["w_dec_b"])))  # < 0
    split = lambda a: a.reshape(*a.shape[:-1], H, dh).movedim(-2, 1)  # noqa: E731
    return split(rr), split(kk), split(vv), split(logw), gg, params["u"].reshape(H, dh)


def _mix_out(params: dict, cfg: ArchConfig, y: torch.Tensor, g: torch.Tensor,
             dtype) -> torch.Tensor:
    """y [b, n, d]: GroupNorm over the H heads, gate, output projection."""
    H = cfg.d_model // cfg.rwkv.head_dim
    y = groupnorm(y.to(dtype), H, params["gn_scale"], params["gn_bias"])
    return (y * g) @ params["w_o"]


def rwkv_time_mix(params: dict, cfg: ArchConfig, x: torch.Tensor,
                  x_last: Optional[torch.Tensor] = None,
                  s0: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix through the chunked scan (n padded with zeros
    to a multiple of its chunk). Returns (out [b, n, d], s_final
    [b, H, dh, dh], x_final [b, d])."""
    b, n, d = x.shape
    r, k, v, logw, g, u = _time_mix_ops(params, cfg, x, _token_shift(x, x_last))
    pad_to = -n % CHUNK
    if pad_to:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad_to)) for a in (r, k, v, logw))
    y, s_fin = lin_attn_chunked(r, k, v, logw, u=u, s0=s0, mamba_style=False)
    y = y[:, :, :n].movedim(1, 2).reshape(b, n, d)
    return _mix_out(params, cfg, y, g, x.dtype), s_fin, x[:, -1, :]


def rwkv_time_mix_step(params: dict, cfg: ArchConfig, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: [b, 1, d]; state: {"S": [b, H, dh, dh],
    "x_last": [b, d]}."""
    b, n, d = x.shape
    if n != 1:
        raise ValueError("a decode step processes one new token")
    r, k, v, logw, g, u = _time_mix_ops(params, cfg, x, _token_shift(x, state["x_last"]))
    y, S = lin_attn_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0],
                                state["S"], u=u, mamba_style=False)
    out = _mix_out(params, cfg, y.reshape(b, 1, d), g, x.dtype)
    return out, {"S": S, "x_last": x[:, -1, :]}


def rwkv_channel_mix(params: dict, x: torch.Tensor,
                     x_last: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix FFN with token shift. Returns (out, x_final [b, d])."""
    x_prev = _token_shift(x, x_last)
    mu = params["mu"]
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    kv = torch.square(F.relu(xk @ params["w_k"])) @ params["w_v"]
    return torch.sigmoid(xr @ params["w_r"]) * kv, x[:, -1, :]


def rwkv_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                    device="cuda") -> dict:
    """Zero decode state of one layer: the WKV state (f32) and both
    token-shift carries. The reference defaults to bf16 carries; the port
    serves f32 caches only, so f32 is its default."""
    dev = resolve_device(device)
    d, dh = cfg.d_model, cfg.rwkv.head_dim
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    return {"tm": {"S": zeros(batch, d // dh, dh, dh, dt=torch.float32),
                   "x_last": zeros(batch, d)},
            "cm_x_last": zeros(batch, d)}
