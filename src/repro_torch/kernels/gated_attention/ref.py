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


_BETA = 0.7978845608028654  # sqrt(2 / pi)
_KAPPA = 0.044715


def gated_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``gated_attention_ref`` written out (not autograd of
    it), the plain version of ``csrc/gated_attention_bwd.cu``. With
    ``c_i = min(i + 1, nk)``, ``S = q kᵀ/√dh``, ``W = gelu_tanh(S)·mask``
    and ``dO' = dO / c``::

        dV = Wᵀ dO'    dW = dO' Vᵀ    dS = dW ⊙ gelu_tanh'(S) ⊙ mask
        dQ = dS K / √dh    dK = dSᵀ Q / √dh

    q/k: [BH, n, dh]; v: [BH, n, dv]; do: [BH, nq, dv]. Returns (dq, dk, dv)
    f32."""
    nq, dh = q.shape[1], q.shape[2]
    nk = k.shape[1]
    scale = dh ** -0.5
    q, k, v = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    qi = torch.arange(nq, device=q.device)
    mask = (torch.arange(nk, device=q.device)[None, :] <= qi[:, None]).to(torch.float32)[None]
    cnt = torch.clamp(qi + 1, max=nk).to(torch.float32)
    dop = do.to(torch.float32) / cnt[None, :, None]
    w = F.gelu(s, approximate="tanh") * mask
    d_v = torch.einsum("bqk,bqd->bkd", w, dop)
    dw = torch.einsum("bqd,bkd->bqk", dop, v)
    t = torch.tanh(_BETA * (s + _KAPPA * s ** 3))
    grad = 0.5 * (1 + t) + 0.5 * s * (1 - t * t) * _BETA * (1 + 3 * _KAPPA * s * s)
    ds = dw * grad * mask
    d_q = torch.einsum("bqk,bkd->bqd", ds, k) * scale
    d_k = torch.einsum("bqk,bqd->bkd", ds, q) * scale
    return d_q, d_k, d_v
