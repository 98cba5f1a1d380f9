"""Streaming (flash-style) attention in plain PyTorch — the port of
``repro/models/flash.py``, which is plain JAX outside any Pallas kernel:
a loop over KV blocks with no [n, n] score tensor.

Two accumulation modes:

* ``softmax=True`` — online softmax (running max and denominator), the
  flash recurrence;
* ``softmax=False`` — the paper's element-wise σ attention (eq. 1): every
  KV block contributes an independent partial sum (no running max, no
  rescale), normalized at the end by the attended count.

Queries go in static blocks, and each q block visits only the KV blocks its
causal / sliding-window mask can reach: fully masked (q block, kv block)
pairs are skipped before any product, as the reference skips them at trace
time. In training autograd differentiates the loop, inside the layer's
checkpoint; the reference's per-block ``remat`` has no counterpart, so a
layer's recompute holds each block's scores until its backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _block_mask(q_idx: torch.Tensor, k_start: int, kv_block: int, n_k: int, *,
                causal: bool, window: Optional[int]) -> torch.Tensor:
    """{0,1} bool mask [nq, kv_block] of one KV block starting at ``k_start``."""
    ki = k_start + torch.arange(kv_block, device=q_idx.device)
    m = (ki < n_k)[None, :].expand(q_idx.shape[0], kv_block)
    if causal:
        m = m & (ki[None, :] <= q_idx[:, None])
    if window is not None:
        m = m & (ki[None, :] > (q_idx[:, None] - window))
    return m


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, softmax: bool = True, kv_block: int = 1024,
                        q_block: int = 1024) -> torch.Tensor:
    """q: [b, nq, H, dqk]; k: [b, nk, Hkv, dqk]; v: [b, nk, Hkv, dv].
    Returns [b, nq, H·dv] (f32 accumulation, cast to v's dtype)."""
    b, nq_all, H, dqk = q.shape
    # the reference's bounds on its static unroll: <=16 kv blocks a q block,
    # <=8 q blocks
    kv_block = max(kv_block, -(-k.shape[1] // 16))
    q_block = max(q_block, -(-nq_all // 8))
    if nq_all > q_block:
        outs = [streaming_attention(q[:, qs:qs + q_block], k, v, causal=causal,
                                    window=window, q_offset=q_offset + qs, softmax=softmax,
                                    kv_block=kv_block, q_block=q_block)
                for qs in range(0, nq_all, q_block)]
        return torch.cat(outs, dim=1)

    nq, nk, Hkv, dv = nq_all, k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hkv
    scale = dqk ** -0.5
    q_idx = q_offset + torch.arange(nq, device=q.device)
    kv_block = min(kv_block, nk)
    nblk_all = -(-nk // kv_block)
    # static reachability: this q block sees keys in (q_offset - window, q_offset + nq)
    lo_blk, hi_blk = 0, nblk_all
    if window is not None:
        lo_blk = max(0, (q_offset - window + 1) // kv_block)
    if causal:
        hi_blk = min(nblk_all, (q_offset + nq - 1) // kv_block + 1)
    nblk = max(hi_blk - lo_blk, 1)
    qf = q.to(torch.float32)

    o = torch.zeros((b, H, nq, dv), dtype=torch.float32, device=q.device)
    if softmax:
        m_run = torch.full((b, H, nq), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, H, nq), dtype=torch.float32, device=q.device)
    else:
        cnt = torch.zeros((nq,), dtype=torch.float32, device=q.device)
    for j in range(lo_blk, lo_blk + nblk):
        ks = j * kv_block
        k_blk, v_blk = k[:, ks:ks + kv_block], v[:, ks:ks + kv_block]
        if k_blk.shape[1] < kv_block:  # the ragged last block, zero-padded
            pad = kv_block - k_blk.shape[1]
            k_blk = F.pad(k_blk, (0, 0, 0, 0, 0, pad))
            v_blk = F.pad(v_blk, (0, 0, 0, 0, 0, pad))
        if rep > 1:
            k_blk = k_blk.repeat_interleave(rep, dim=2)
            v_blk = v_blk.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.to(torch.float32)) * scale
        mask = _block_mask(q_idx, ks, kv_block, nk, causal=causal, window=window)
        vf = v_blk.to(torch.float32)
        if softmax:
            s = torch.where(mask[None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
            l_run = l_run * alpha + p.sum(-1)
            m_run = m_new
        else:
            w = F.gelu(s, approximate="tanh") * mask[None, None]
            o = o + torch.einsum("bhqk,bkhd->bhqd", w, vf)
            cnt = cnt + mask.sum(-1).to(torch.float32)
    if softmax:
        o = o / torch.clamp(l_run[..., None], min=1e-9)
    else:
        o = o / torch.clamp(cnt, min=1.0)[None, None, :, None]
    return o.transpose(1, 2).reshape(b, nq, H * dv).to(v.dtype)
