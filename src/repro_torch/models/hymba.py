"""Hymba hybrid-head mixer (arXiv:2411.13676) — the port of
``repro/models/hymba.py``.

Each block runs *parallel* attention heads and Mamba-2 (SSD) heads over
the same input and fuses their (independently normalized) outputs:

    out = W_o ( VQ( mean( norm(attn(x)), norm(ssm(x)) ) ) )

The attention branch is the port's GQA (``models.attention``): a σ,
unwindowed layer runs the ``gated_attention`` kernel, a windowed one a ring
cache in decode and ``streaming_attention`` past ``STREAM_THRESHOLD``. The
SSM branch is a Mamba-2 style selective recurrence with a scalar-per-head
decay through ``models.linear_scan`` (``mamba_style=True``). With VQT the
fused output goes through ``core.vq.quantize`` (the ``vq_assign`` kernel).

Parameter layout (each leaf with the stage's leading repeat dims):
``wq [d, H·dh]``, ``wk / wv [d, Hkv·dh]``, ``w_xz [d, 2·d_inner]``,
``conv_w [d_conv, d_inner]``, ``conv_b [d_inner]``, ``w_B / w_C [d,
d_state]``, ``w_dt [d, H]``, ``dt_bias / A_log [H]``, ``norm_attn /
norm_ssm.scale [d_inner]``, ``wo [H·dh, d]`` and, with VQT,
``vq.codebook [hq, Q, H·dh / hq]``; d_inner = H·dh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.core import vq as vq_mod
from repro_torch.models import normal
from repro_torch.models.attention import (
    apply_rope, attn_cache_init, attn_decode_core, full_attention,
)
from repro_torch.models.linear_scan import CHUNK, lin_attn_chunked, lin_attn_decode_step
from repro_torch.models.norms import rmsnorm


def hymba_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg, r: tuple = ()) -> dict:
    """Parameters with leading dims ``r``, at the reference's scales (its
    draws come from ``jax.random``, these from ``gen``)."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    s = cfg.ssm
    d_inner = H * dh  # the ssm branch's width matches the attention branch
    sc = d ** -0.5
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32) / 4.0 + 0.5)
    p = {
        "wq": normal(gen, r + (d, H * dh), sc),
        "wk": normal(gen, r + (d, Hkv * dh), sc),
        "wv": normal(gen, r + (d, Hkv * dh), sc),
        "w_xz": normal(gen, r + (d, 2 * d_inner), sc),
        "conv_w": normal(gen, r + (s.d_conv, d_inner), 0.3),
        "conv_b": torch.zeros(r + (d_inner,)),
        "w_B": normal(gen, r + (d, s.d_state), sc),
        "w_C": normal(gen, r + (d, s.d_state), sc),
        "w_dt": normal(gen, r + (d, H), sc),
        "dt_bias": torch.zeros(r + (H,)),
        "A_log": a_log.expand(r + (H,)).clone(),
        "norm_attn": {"scale": torch.ones(r + (H * dh,))},
        "norm_ssm": {"scale": torch.ones(r + (d_inner,))},
        "wo": normal(gen, r + (H * dh, d), (H * dh) ** -0.5),
    }
    if cfg.vqt is not None:
        p["vq"] = vq_mod.init(gen, H * dh, cfg.vqt, r)
    return p


def _ssm_qkv(params: dict, cfg: ArchConfig, xc: torch.Tensor, x_raw: torch.Tensor):
    """The linear-recurrence operands from the conv'd ssm stream ``xc``
    [b, n, d_inner] and the raw block input ``x_raw`` [b, n, d]: q = C and
    k = B·dt broadcast over the H heads ([b, H, n, d_state]), v the heads of
    ``xc`` ([b, H, n, dh]), and the scalar log decay -(dt·A) of each head
    broadcast over d_state."""
    H = cfg.n_heads
    b, n, d_inner = xc.shape
    ds = cfg.ssm.d_state
    Bm = x_raw @ params["w_B"]  # [b, n, ds], shared across heads
    Cm = x_raw @ params["w_C"]
    dt = F.softplus(x_raw.to(torch.float32) @ params["w_dt"].to(torch.float32)
                    + params["dt_bias"])  # [b, n, H]
    logw = -(dt * torch.exp(params["A_log"]))  # [b, n, H]
    dt_h = dt.movedim(-1, 1)[..., None]  # [b, H, n, 1]
    q = Cm[:, None].expand(b, H, n, ds)
    k = Bm[:, None].expand(b, H, n, ds) * dt_h
    v = xc.reshape(b, n, H, d_inner // H).movedim(2, 1)
    return q, k, v, logw.movedim(-1, 1)[..., None].expand(b, H, n, ds)


def _causal_conv(params: dict, xc: torch.Tensor, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, then SiLU. xc: [b, n, d_inner];
    conv_state: [b, d_conv - 1, d_inner], the previous call's last inputs
    (decode). Returns (out, new conv_state)."""
    w = params["conv_w"]  # [d_conv, d_inner]
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xc.shape[0], K - 1, xc.shape[2]), dtype=xc.dtype, device=xc.device)
    else:
        pad = conv_state.to(xc.dtype)
    xp = torch.cat([pad, xc], dim=1)  # [b, n + K - 1, d_inner]
    n = xc.shape[1]
    out = xp[:, 0:n] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + n] * w[i]
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else torch.zeros_like(pad)
    return F.silu(out + params["conv_b"]), new_state


def _fuse(params: dict, attn_out: torch.Tensor, ssm_out: torch.Tensor) -> torch.Tensor:
    """The mean of the two normed branches, VQ (inference), the output
    projection."""
    fused = 0.5 * (rmsnorm(params["norm_attn"], attn_out) + rmsnorm(params["norm_ssm"], ssm_out))
    if "vq" in params:
        fused, _ = vq_mod.quantize(params["vq"], fused)
    return fused @ params["wo"]


def hymba_apply(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                positions: torch.Tensor, *, train: bool = False,
                vq_rng=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full (prefill-style) hybrid mixer over [b, n, d]. Returns (out
    [b, n, d], vq aux loss — 0 at inference)."""
    if train:
        raise NotImplementedError(
            "training-mode VQ comes with the port's training slice (ROADMAP Queue A item 10)")
    b, n, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    # attention branch
    q = (x @ params["wq"]).reshape(b, n, H, dh)
    k = (x @ params["wk"]).reshape(b, n, Hkv, dh)
    v = (x @ params["wv"]).reshape(b, n, Hkv, dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    attn_out = full_attention(q, k, v, causal=True, window=layer.window,
                              softmax=cfg.attn_softmax)  # [b, n, H·dh]
    # ssm branch
    xs, z = (x @ params["w_xz"]).chunk(2, dim=-1)  # each [b, n, d_inner]
    xc, _ = _causal_conv(params, xs)
    qs, ks, vs, logw = _ssm_qkv(params, cfg, xc, x)
    pad_to = -n % CHUNK
    if pad_to:
        qs, ks, vs, logw = (F.pad(a, (0, 0, 0, pad_to)) for a in (qs, ks, vs, logw))
    y, _ = lin_attn_chunked(qs, ks, vs, logw, mamba_style=True)
    ssm_out = y[:, :, :n].movedim(1, 2).reshape(b, n, H * dh).to(x.dtype) * F.silu(z)
    return _fuse(params, attn_out, ssm_out), torch.zeros((), device=x.device)


def hymba_decode(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                 cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode. cache: {"attn": the attention branch's KV cache
    (a ring for a windowed layer), "ssm_state": [b, H, d_state, dh],
    "conv_state": [b, d_conv - 1, d_inner]}."""
    b, n, _ = x.shape
    if n != 1:
        raise ValueError("a decode step processes one new token")
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, 1, H, dh)
    k_new = (x @ params["wk"]).reshape(b, 1, Hkv, dh)
    v_new = (x @ params["wv"]).reshape(b, 1, Hkv, dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
    attn_out, attn_cache = attn_decode_core(cfg, layer, q, k_new, v_new, cache["attn"])
    xs, z = (x @ params["w_xz"]).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(params, xs, conv_state=cache["conv_state"])
    qs, ks, vs, logw = _ssm_qkv(params, cfg, xc, x)
    y, S = lin_attn_decode_step(qs[:, :, 0], ks[:, :, 0], vs[:, :, 0], logw[:, :, 0],
                                cache["ssm_state"], mamba_style=True)
    ssm_out = y.reshape(b, 1, H * dh).to(x.dtype) * F.silu(z)
    return _fuse(params, attn_out, ssm_out), {
        "attn": attn_cache, "ssm_state": S, "conv_state": conv_state}


def hymba_cache_init(cfg: ArchConfig, layer: LayerCfg, batch: int, seq_len: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Zero decode cache of one layer (f32 by default, as every port cache:
    the reference's bf16 default is not served)."""
    dev = resolve_device(device)
    H, dh = cfg.n_heads, cfg.resolved_head_dim
    s = cfg.ssm
    return {
        "attn": attn_cache_init(cfg, layer, batch, seq_len, dtype, dev),
        "ssm_state": torch.zeros((batch, H, s.d_state, dh), dtype=torch.float32, device=dev),
        "conv_state": torch.zeros((batch, s.d_conv - 1, H * dh), dtype=dtype, device=dev),
    }
