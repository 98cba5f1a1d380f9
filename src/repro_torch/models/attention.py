"""GQA attention — the port of ``repro/models/attention.py``: RoPE, sliding
windows, softmax or the paper's element-wise σ attention (eq. 1), the VQ
hook on the concatenated head outputs (before the mixing projection, paper
§3), and the KV-cache prefill / decode steps (full caches, and ring buffers
for windowed layers).

σ-attention normalization: each output row is divided by the number of
positions it attends, which keeps magnitudes independent of the sequence
length and stays incrementally patchable.

Routing as in the reference with ``USE_PALLAS_SIGMA`` on
(``attention.py:131-143``): a σ-causal, unwindowed, unpadded
``full_attention`` runs the ``gated_attention`` kernel (its plain version
on CPU tensors); otherwise a sequence longer than ``STREAM_THRESHOLD``
takes ``flash.streaming_attention``; every other case runs the dense
``attention_core``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.core import vq as vq_mod
from repro_torch.kernels.gated_attention import gated_attention
from repro_torch.models import normal
from repro_torch.models.flash import streaming_attention

# sequences longer than this take the streaming path; a module attribute so
# tests can force either path and compare
STREAM_THRESHOLD = 2048


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of the two halves of the head dim. x: [b, n, h, dh];
    positions: [b, n] ints."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [dh/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [b, n, dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attn_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg, r: tuple = ()) -> dict:
    """GQA parameters (biases where ``cfg.attn_bias``, the VQ codebook where
    ``cfg.vqt``) with leading dims ``r``, at the reference's scales (its
    draws come from ``jax.random``, these from ``gen``)."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    zeros = lambda *s: torch.zeros(r + s, dtype=torch.float32)
    mixer = {
        "wq": normal(gen, r + (d, H * dh), d ** -0.5),
        "wk": normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wv": normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wo": normal(gen, r + (H * dh, d), (H * dh) ** -0.5),
    }
    if cfg.attn_bias:
        mixer.update(bq=zeros(H * dh), bk=zeros(Hkv * dh), bv=zeros(Hkv * dh),
                     bo=zeros(d))
    if cfg.vqt is not None:
        mixer["vq"] = vq_mod.init(gen, H * dh, cfg.vqt, r)
    return mixer


def _qkv(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """q [b, n, H, dh], k and v [b, n, Hkv, dh]; q and k rotated under RoPE."""
    b, n, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q, k, v = q.reshape(b, n, H, dh), k.reshape(b, n, Hkv, dh), v.reshape(b, n, Hkv, dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sigma_attn_weights(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Paper eq. 1: element-wise GELU instead of softmax, masked entries 0,
    rows normalized by their attended count."""
    w = F.gelu(scores, approximate="tanh") * mask
    counts = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    return w / counts


def make_mask(n_q: int, n_k: int, *, causal: bool, window: Optional[int],
              q_offset=0, valid_k: Optional[torch.Tensor] = None,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 1, n_q, n_k] {0,1} mask ([b, 1, n_q, n_k] with ``valid_k``).
    q_offset: absolute index of the first query."""
    qi = torch.arange(n_q, device=device) + q_offset
    ki = torch.arange(n_k, device=device)
    m = torch.ones((n_q, n_k), dtype=torch.bool, device=device)
    if causal:
        m &= ki[None, :] <= qi[:, None]
    if window is not None:
        m &= ki[None, :] > (qi[:, None] - window)
    m = m[None, None].to(dtype)
    if valid_k is not None:  # [b, n_k] validity (padding / ring cache)
        m = m * valid_k[:, None, None, :].to(dtype)
    return m


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   softmax: bool = True,
                   valid_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over a full sequence: the σ kernel for the VQT case,
    else the streaming KV-block path for long sequences (no [n, n] score
    tensor), else the dense core. q: [b, n, H, dh]; k, v: [b, n, Hkv, dh]."""
    n = q.shape[1]
    if not softmax and causal and window is None and valid_k is None:
        return gated_attention(q, k, v)
    if n > STREAM_THRESHOLD and valid_k is None:
        return streaming_attention(q, k, v, causal=causal, window=window, softmax=softmax)
    mask = make_mask(n, k.shape[1], causal=causal, window=window,
                     valid_k=valid_k, device=q.device)
    return attention_core(q, k, v, mask, softmax=softmax)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, *, softmax: bool) -> torch.Tensor:
    """q: [b, nq, H, dh]; k, v: [b, nk, Hkv, dh]; mask [b|1, 1, nq, nk].
    Returns [b, nq, H·dh]."""
    b, nq, H, dh = q.shape
    rep = H // k.shape[2]
    kr = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vr = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) * dh ** -0.5
    if softmax:
        w = torch.softmax(torch.where(mask > 0, scores, -1e30), dim=-1)
    else:
        w = sigma_attn_weights(scores, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), vr)
    return out.reshape(b, nq, H * dh)


def _project_out(params: dict, o: torch.Tensor) -> torch.Tensor:
    """VQ hook (inference), then the mixing projection."""
    if "vq" in params:
        o, _ = vq_mod.quantize(params["vq"], o)
    return _mix(params, o)


def _mix(params: dict, o: torch.Tensor) -> torch.Tensor:
    o = o @ params["wo"]
    if "bo" in params:
        o = o + params["bo"]
    return o


def attn_apply(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
               positions: torch.Tensor, *, train: bool = False,
               vq_noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full (train / prefill) attention over [b, n, d]. Returns (out
    [b, n, d], vq aux loss — 0 at inference). With ``train`` the VQ hook is
    the Gumbel straight-through ``vq.forward_train`` with ``vq_noise`` (the
    scores' shape, [b, n, hq, Q]; None: no noise), as the reference's
    ``attention.py:192-222``; the σ core stays the ``gated_attention``
    kernel (differentiable), the softmax core plain PyTorch."""
    q, k, v = _qkv(params, cfg, x, positions)
    o = full_attention(q, k, v, causal=True, window=layer.window,
                       softmax=cfg.attn_softmax)
    if train and "vq" in params:
        o, _, aux = vq_mod.forward_train(params["vq"], o, cfg.vqt, noise=vq_noise)
        return _mix(params, o), aux
    return _project_out(params, o), torch.zeros((), device=x.device)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """A copy of ``cache`` [b, S, ...] with ``new`` [b, m, ...] written at rows
    ``start[b] .. start[b] + m - 1``. Like ``jax.lax.dynamic_update_slice``,
    the start is clamped so the write stays inside the cache."""
    b, m = new.shape[:2]
    S = cache.shape[1]
    start = torch.clamp(start.long(), min=0, max=S - m)
    rows = start[:, None] + torch.arange(m, device=cache.device)[None]
    out = cache.clone()
    out[torch.arange(b, device=cache.device)[:, None], rows] = new.to(cache.dtype)
    return out


def attn_decode_core(cfg: ArchConfig, layer: LayerCfg, q: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     cache: dict) -> tuple[torch.Tensor, dict]:
    """Cache update + attention for one decode token. q: [b, 1, H, dh];
    k_new/v_new: [b, 1, Hkv, dh]; cache {"k", "v": [b, S, Hkv, dh],
    "len": [b] int32}. For windowed layers S is the window (or the sequence,
    if shorter) and writes wrap: a ring buffer. Returns (out [b, 1, H·dh],
    new_cache)."""
    S = cache["k"].shape[1]
    cache_len = cache["len"]
    if layer.window is not None:
        slot = cache_len % S  # ring buffer
    else:
        slot = torch.clamp(cache_len, max=S - 1)
    k = _write_rows(cache["k"], k_new, slot)
    v = _write_rows(cache["v"], v_new, slot)
    # slot j holds a real token iff j < len + 1 (a ring: all, once len + 1 >= S)
    ki = torch.arange(S, device=q.device)[None, :]
    valid = ki < torch.clamp(cache_len + 1, max=S)[:, None]
    mask = valid[:, None, None, :].to(torch.float32)
    o = attention_core(q, k, v, mask, softmax=cfg.attn_softmax)
    return o, {"k": k, "v": v, "len": cache_len + 1}


def attn_decode(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One-token decode step against a KV cache. x: [b, 1, d]."""
    if x.shape[1] != 1:
        raise ValueError("a decode step processes one new token")
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    o, new_cache = attn_decode_core(cfg, layer, q, k_new, v_new, cache)
    return _project_out(params, o), new_cache


def attn_prefill(params: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                 cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: append ``m`` tokens ([b, m, d]) to a KV cache in one
    step. Chunk token i sees cache slot j iff ``j <= len + i``; with m = 1
    this is exactly ``attn_decode``. Needs a full (non-ring) cache and
    ``len + m <= S`` (the write is clamped like the reference's
    ``dynamic_update_slice``, which would corrupt the cache)."""
    m = x.shape[1]
    if layer.window is not None:
        raise ValueError("chunked prefill requires a non-windowed layer "
                         "(ring caches only support one-token decode)")
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    S = cache["k"].shape[1]
    start = cache["len"]
    k = _write_rows(cache["k"], k_new, start)
    v = _write_rows(cache["v"], v_new, start)
    qi = start[:, None] + torch.arange(m, device=x.device)[None, :]
    ki = torch.arange(S, device=x.device)
    mask = (ki[None, None, :] <= qi[:, :, None]).to(torch.float32)[:, None]
    o = attention_core(q, k, v, mask, softmax=cfg.attn_softmax)
    return _project_out(params, o), {"k": k, "v": v, "len": start + m}


def attn_cache_init(cfg: ArchConfig, layer: LayerCfg, batch: int, seq_len: int,
                    dtype=torch.float32, device="cuda") -> dict:
    """Zero KV cache of one layer: ``seq_len`` slots, or a ring of
    ``min(window, seq_len)`` for a windowed layer. The reference defaults to
    bf16; the port serves f32 caches only so far, so f32 is its default."""
    device = resolve_device(device)
    S = min(layer.window, seq_len) if layer.window is not None else seq_len
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, S, Hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, Hkv, dh), dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
