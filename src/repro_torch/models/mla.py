"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2405.04434 §2.1) — the
port of ``repro/models/mla.py``.

Prefill uses the *naive* (expanded) form; decode uses the *absorbed* form,
caching only the compressed latent ``c_kv`` (kv_lora dims) plus the shared
RoPE key (rope_dim dims) per token — 576 floats a token for V2/V3 instead
of 2·H·dh.

The reference computes MLA in plain JAX, so the port computes it in plain
PyTorch: the σ weights here never go through the ``gated_attention`` kernel
(q·k is nope + rope wide, v is v_dim wide). Sequences longer than
``attention.STREAM_THRESHOLD`` fold the shared RoPE key into a combined head
dim and take ``flash.streaming_attention``. With VQT the concatenated head
outputs go through ``core.vq.quantize`` (the ``vq_assign`` kernel), or in
training through ``core.vq.forward_train`` with the layer's noise; autograd
differentiates the rest, as the reference differentiates plain JAX.

Weights (each with the stage's leading repeat dims)::

    w_dq:  [d, q_lora]         w_uq: [q_lora, H·(nope + rope)]
    w_dkv: [d, kv_lora + rope] w_uk: [kv_lora, H·nope]   w_uv: [kv_lora, H·v]
    wo:    [H·v, d]            q_norm.scale [q_lora], kv_norm.scale [kv_lora]
    vq.codebook [hq, Q, H·v / hq] (VQT)
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.core import vq as vq_mod
from repro_torch.models import attention, normal
from repro_torch.models.attention import (
    _mix, _project_out, _write_rows, apply_rope, make_mask,
)
from repro_torch.models.flash import streaming_attention
from repro_torch.models.norms import norm_init, rmsnorm


def mla_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg, r: tuple = ()) -> dict:
    """Parameters with leading dims ``r``, at the reference's scales (its
    draws come from ``jax.random``, these from ``gen``)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    p = {
        "w_dq": normal(gen, r + (d, m.q_lora), d ** -0.5),
        "w_uq": normal(gen, r + (m.q_lora, H * (m.nope_dim + m.rope_dim)), m.q_lora ** -0.5),
        "w_dkv": normal(gen, r + (d, m.kv_lora + m.rope_dim), d ** -0.5),
        "w_uk": normal(gen, r + (m.kv_lora, H * m.nope_dim), m.kv_lora ** -0.5),
        "w_uv": normal(gen, r + (m.kv_lora, H * m.v_dim), m.kv_lora ** -0.5),
        "wo": normal(gen, r + (H * m.v_dim, d), (H * m.v_dim) ** -0.5),
        "q_norm": norm_init("rmsnorm", m.q_lora, r),
        "kv_norm": norm_init("rmsnorm", m.kv_lora, r),
    }
    if cfg.vqt is not None:
        p["vq"] = vq_mod.init(gen, H * m.v_dim, cfg.vqt, r)
    return p


def _queries(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """q_nope [b, n, H, nope] and the rotated q_rope [b, n, H, rope]."""
    m = cfg.mla
    b, n, _ = x.shape
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"])
    q = (cq @ params["w_uq"]).reshape(b, n, cfg.n_heads, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """The normed latent c_kv [b, n, kv_lora] and the shared rotated RoPE key
    k_rope [b, n, 1, rope] (one head for all H)."""
    m = cfg.mla
    ckv_full = x @ params["w_dkv"]  # [b, n, kv_lora + rope]
    c_kv = rmsnorm(params["kv_norm"], ckv_full[..., :m.kv_lora])
    k_rope = apply_rope(ckv_full[..., None, m.kv_lora:], positions, cfg.rope_theta)
    return c_kv, k_rope


def _weights(scores: torch.Tensor, valid: torch.Tensor, softmax: bool) -> torch.Tensor:
    """Attention weights from f32 ``scores`` [b, H, nq, nk] under the {0,1}
    or bool ``valid`` mask: a masked softmax, or the σ weights of
    ``attention.sigma_attn_weights`` with the mask and the count applied in
    place (at full width a [1, 128, 4096, 4096] score tensor is 8.6 GB).
    The scores may be overwritten."""
    if softmax:
        return torch.softmax(scores.masked_fill_(~(valid > 0), -1e30), dim=-1)
    mask = valid.to(torch.float32)
    counts = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return F.gelu(scores, approximate="tanh").mul_(mask).div_(counts)


def mla_apply(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
              positions: torch.Tensor, *, train: bool = False,
              vq_noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Naive (expanded) MLA over [b, n, d]. Returns (out [b, n, d], vq aux
    loss — 0 at inference). With ``train`` the VQ hook is the Gumbel
    straight-through ``vq.forward_train`` with ``vq_noise`` (as the
    reference's ``mla.py:126-127``); autograd differentiates the rest."""
    m = cfg.mla
    b, n, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _queries(params, cfg, x, positions)
    c_kv, k_rope = _latent(params, cfg, x, positions)
    k_nope = (c_kv @ params["w_uk"]).reshape(b, n, H, m.nope_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, n, H, m.v_dim)
    if n > attention.STREAM_THRESHOLD:
        # fold the shared RoPE key into a combined head dim
        q_cat = torch.cat([q_nope, q_rope], dim=-1)  # [b, n, H, nope + rope]
        del q_nope, q_rope
        k_cat = torch.cat([k_nope, k_rope.expand(b, n, H, m.rope_dim)], dim=-1)
        del k_nope
        o = streaming_attention(q_cat, k_cat, v, causal=True, window=layer.window,
                                softmax=cfg.attn_softmax)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.to(torch.float32),
                              k_nope.to(torch.float32))
        scores += torch.einsum("bqhd,bkxd->bhqk", q_rope.to(torch.float32),
                               k_rope.to(torch.float32))
        scores *= (m.nope_dim + m.rope_dim) ** -0.5
        del q_nope, k_nope
        mask = make_mask(n, n, causal=True, window=layer.window, device=x.device)
        w = _weights(scores, mask, cfg.attn_softmax)
        del scores
        o = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v).reshape(b, n, H * m.v_dim)
        del w
    if train and "vq" in params:
        o, _, aux = vq_mod.forward_train(params["vq"], o, cfg.vqt, noise=vq_noise)
        return _mix(params, o), aux
    return _project_out(params, o), torch.zeros((), device=x.device)


def mla_decode(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
               cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Absorbed-form decode of one token ([b, 1, d]) in the kv_lora latent
    space. cache: {"ckv": [b, S, kv_lora], "krope": [b, S, rope], "len": [b]
    int32}; the new token goes to slot ``min(len, S - 1)``. Per token:
    q̃ = q_nope·W_uk (absorbed), scores = q̃·c_kv + q_rope·k_rope, o_lat =
    w·c_kv, then o = o_lat·W_uv per head — W_uv applied once a step, not per
    cached token. Returns (out [b, 1, d], new cache)."""
    m = cfg.mla
    b, n, _ = x.shape
    if n != 1:
        raise ValueError("a decode step processes one new token")
    H = cfg.n_heads
    q_nope, q_rope = _queries(params, cfg, x, positions)  # [b, 1, H, *]
    c_new, krope_new = _latent(params, cfg, x, positions)  # [b, 1, kv], [b, 1, 1, rope]
    S = cache["ckv"].shape[1]
    cache_len = cache["len"]
    slot = torch.clamp(cache_len, max=S - 1)
    ckv = _write_rows(cache["ckv"], c_new, slot)
    krope = _write_rows(cache["krope"], krope_new[:, :, 0], slot)
    w_uk = params["w_uk"].reshape(m.kv_lora, H, m.nope_dim)  # [c, h, d]
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)
    scores = torch.einsum("bqhc,bkc->bhqk", q_lat.to(torch.float32), ckv.to(torch.float32))
    scores += torch.einsum("bqhd,bkd->bhqk", q_rope.to(torch.float32),
                           krope.to(torch.float32))
    scores *= (m.nope_dim + m.rope_dim) ** -0.5
    ki = torch.arange(S, device=x.device)[None, :]
    valid = (ki < torch.clamp(cache_len + 1, max=S)[:, None])[:, None, None, :]
    w = _weights(scores, valid, cfg.attn_softmax)
    o_lat = torch.einsum("bhqk,bkc->bqhc", w.to(ckv.dtype), ckv)  # [b, 1, H, kv]
    w_uv = params["w_uv"].reshape(m.kv_lora, H, m.v_dim)
    o = torch.einsum("bqhc,chd->bqhd", o_lat, w_uv).reshape(b, n, H * m.v_dim)
    return _project_out(params, o), {"ckv": ckv, "krope": krope, "len": cache_len + 1}


def mla_cache_init(cfg: ArchConfig, layer: LayerCfg, batch: int, seq_len: int,
                   dtype=torch.float32, device="cuda") -> dict:
    """Zero latent cache of one layer. The reference defaults to bf16; the
    port serves f32 caches, so f32 is its default."""
    device = resolve_device(device)
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, seq_len, m.kv_lora), dtype=dtype, device=device),
        "krope": torch.zeros((batch, seq_len, m.rope_dim), dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
