"""Shared linear-recurrence core of the SSM-family mixers (Mamba2 SSD in
Hymba, RWKV6) — the port of ``repro/models/linear_scan.py``.

Recurrence (per batch & head, state S ∈ R^{dk×dv}):

    S_t = diag(λ_t) S_{t-1} + k_t v_tᵀ
    y_t = (q_t ⊙ d_t) · S_{t-1} + (q_t ⊙ u ⊙ k_t) · v_t

with per-channel decay λ_t = exp(logw_t) ∈ (0, 1]. d_t = 1 and a learned
bonus u give RWKV6's WKV; d_t = λ_t and u = 1 (``mamba_style``) give
Mamba-2's SSD with a scalar-per-head decay broadcast over dk.

Two implementations, as in the reference:
* ``lin_attn_sequential`` — a Python loop over time: the oracle (tests and
  the decode step's arithmetic).
* ``lin_attn_chunked`` — n/CHUNK chunks of dense products, with in-chunk
  decays from cumulative log sums; the carry over chunks is a Python loop
  where the reference runs ``lax.scan``. The per-step log decay is clipped
  to >= ``MIN_LOGW`` so the inverse in-chunk decay exp(-W) stays inside
  f32 range (16 × 5: e^80 < f32 max). This holds only in full f32
  products: TF32 matmuls would lose the 1e-4 bound against the sequential
  scan.

Both are plain PyTorch, differentiated by autograd in training: the
reference computes and differentiates them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

MIN_LOGW = -5.0
CHUNK = 16


def _prep(q, k, v, logw, u, mamba_style):
    """f32 operands, clipped log decay, λ, d and the effective bonus u.
    q, k, logw: [b, h, n, dk]; v: [b, h, n, dv]; u: None or [h, dk]."""
    logw = torch.clamp(logw.to(torch.float32), MIN_LOGW, 0.0)
    lam = torch.exp(logw)
    d = lam if mamba_style else torch.ones_like(lam)
    if u is None:
        u_eff = torch.ones((q.shape[1], q.shape[-1]), dtype=torch.float32, device=q.device)
    else:
        u_eff = u.to(torch.float32)
    f32 = lambda a: a.to(torch.float32)  # noqa: E731
    return f32(q), f32(k), f32(v), logw, lam, d, u_eff


def _step(qt, kt, vt, lt, dt, u_eff, S):
    """One token: qt, kt, lt, dt [b, h, dk]; vt [b, h, dv]; S [b, h, dk, dv].
    Returns (y [b, h, dv], S')."""
    y = ((qt * dt)[..., None, :] @ S)[..., 0, :] + (qt * u_eff * kt).sum(-1, keepdim=True) * vt
    return y, lt[..., None] * S + kt[..., None] * vt[..., None, :]


def _zero_state(q, v, s0):
    b, h, _, dk = q.shape
    if s0 is not None:
        return s0.to(torch.float32)
    return torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32, device=q.device)


def lin_attn_sequential(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: Optional[torch.Tensor] = None,
                        s0: Optional[torch.Tensor] = None, *,
                        mamba_style: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [b, h, n, dv], s_final [b, h, dk, dv])."""
    q, k, v, logw, lam, d, u_eff = _prep(q, k, v, logw, u, mamba_style)
    S = _zero_state(q, v, s0)
    ys = []
    for t in range(q.shape[2]):
        y, S = _step(q[:, :, t], k[:, :, t], v[:, :, t], lam[:, :, t], d[:, :, t], u_eff, S)
        ys.append(y)
    return torch.stack(ys, dim=2), S


def lin_attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: Optional[torch.Tensor] = None,
                     s0: Optional[torch.Tensor] = None, *, mamba_style: bool = False,
                     chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked (matmul-form) evaluation; same contract as the sequential
    scan. n must be a multiple of ``chunk`` (callers pad with zeros: a
    padded step has logw = 0 and k = 0, so the final state is unchanged)."""
    q, k, v, logw, lam, d, u_eff = _prep(q, k, v, logw, u, mamba_style)
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    L = chunk
    if n % L:
        raise ValueError(f"seq {n} must be a multiple of chunk {L} (pad upstream)")
    C = n // L
    S = _zero_state(q, v, s0)

    rc = lambda a: a.reshape(b, h, C, L, a.shape[-1])  # noqa: E731
    qc, kc, vc, lwc, dc = map(rc, (q, k, v, logw, d))
    W = torch.cumsum(lwc, dim=3)  # inclusive in-chunk cumulative log decay
    Wtot = W[:, :, :, -1:, :]  # [b, h, C, 1, dk]
    q_in = qc * dc * torch.exp(W - lwc)  # q_t ⊙ d_t ⊙ P_{t-1}/P_{c0}
    k_out = kc * torch.exp(-W)  # k_s ⊙ P_{c0}/P_s
    k_carry = kc * torch.exp(Wtot - W)  # k_s ⊙ P_end/P_s

    # intra-chunk attention (strictly lower-triangular) + the u diagonal
    A = q_in @ k_out.transpose(-1, -2)  # [b, h, C, L(query), L(key)]
    A = A * torch.tril(torch.ones((L, L), dtype=torch.float32, device=q.device), diagonal=-1)
    diag = (qc * u_eff[None, :, None, None, :] * kc).sum(-1)
    y_intra = A @ vc + diag[..., None] * vc

    # inter-chunk carry: each chunk's [dk, dv] state delta is formed inside
    # the loop, so no [b, h, C, dk, dv] tensor exists. The loop is host
    # launches (three a chunk: the cross term, the decay, the delta added
    # in the product's epilogue), so its operands are split once, with b
    # and h folded into the products' batch. The cross terms are stacked
    # after the loop (autograd differentiates no product written ``out=``).
    bh = b * h
    lam_tot = torch.exp(Wtot).reshape(bh, C, dk, 1).unbind(1)  # per chunk [bh, dk, 1]
    q_c = q_in.reshape(bh, C, L, dk).unbind(1)
    kT_c = k_carry.reshape(bh, C, L, dk).transpose(-1, -2).unbind(1)  # [bh, dk, L]
    v_c = vc.reshape(bh, C, L, dv).unbind(1)
    S = S.reshape(bh, dk, dv)
    cross = []
    for c in range(C):
        cross.append(torch.bmm(q_c[c], S))
        S = torch.baddbmm(lam_tot[c] * S, kT_c[c], v_c[c])
    y = y_intra + torch.stack(cross).reshape(C, b, h, L, dv).movedim(0, 2)
    return y.reshape(b, h, n, dv), S.reshape(b, h, dk, dv)


def lin_attn_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, S: torch.Tensor,
                         u: Optional[torch.Tensor] = None, *,
                         mamba_style: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token state update. q, k, logw: [b, h, dk]; v: [b, h, dv];
    S: [b, h, dk, dv]. Returns (y [b, h, dv], S')."""
    q, k, v, _, lam, d, u_eff = _prep(q[:, :, None], k[:, :, None], v[:, :, None],
                                      logw[:, :, None], u, mamba_style)
    return _step(q[:, :, 0], k[:, :, 0], v[:, :, 0], lam[:, :, 0], d[:, :, 0], u_eff, S)
