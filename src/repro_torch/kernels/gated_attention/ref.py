"""Plain PyTorch version of the gated σ-attention kernel
(``csrc/gated_attention.cu``), the port of
``repro/kernels/gated_attention/ref.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gated_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal σ-attention, count-normalized. q/k: [BH, n, dh]; v: [BH, n, dv].
    Row i attends keys j <= i (j < nk) and divides by min(i + 1, nk).
    Returns [BH, nq, dv] f32."""
    nq, dh = q.shape[1], q.shape[2]
    nk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32)) * dh ** -0.5
    qi = torch.arange(nq, device=q.device)
    mask = torch.arange(nk, device=q.device)[None, :] <= qi[:, None]
    w = F.gelu(s, approximate="tanh") * mask[None].to(torch.float32)
    cnt = torch.clamp(qi + 1, max=nk).to(torch.float32)
    return torch.einsum("bqk,bkd->bqd", w, v.to(torch.float32)) / cnt[None, :, None]
