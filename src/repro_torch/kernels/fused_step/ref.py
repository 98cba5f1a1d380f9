"""Plain PyTorch versions of the fused edit-step kernels.

``fused_patch_assign_ref`` is the unfused chain of
``repro/kernels/fused_step/ref.py``: the masked old-minus/new-plus column
patch (``incr_patch_ref``), the T accumulate and the score-space
requantize. ``delta_gate_ref`` is the sigma-delta gate. Both take any
number of leading batch axes. The kernel wrappers in ``ops.py`` run these
for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernels against them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_patch_assign_ref(q, k_new, k_old, vc_new, vc_old, mask, T_base,
                           counts, vq_bias) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [..., n, H, dh]; k_*: [..., H, C, dh]; vc_*: [..., H, C, Q];
    mask: [..., n, C]; T_base: [..., n, H, Q]; counts: [..., n];
    vq_bias: [hq, Q] (``heads_per_vq`` = H // hq).
    Returns (T_all [..., n, H, Q] f32, codes [..., n, hq] int32) with
    ``T_all = T_base + ΔT`` and ``codes = argmax_Q(Σ_heads T_all / counts
    + vq_bias)`` (first maximum on ties)."""
    scale = q.shape[-1] ** -0.5
    w_mask = mask.to(torch.float32).unsqueeze(-2)  # [..., n, 1, C]

    def contrib(k, vc):
        s = torch.einsum("...nhd,...hcd->...nhc", q, k) * scale
        w = F.gelu(s, approximate="tanh") * w_mask
        return torch.einsum("...nhc,...hcq->...nhq", w, vc)

    T_all = T_base.to(torch.float32) + (contrib(k_new, vc_new)
                                        - contrib(k_old, vc_old))
    *lead, n, H, Q = T_all.shape
    hq = vq_bias.shape[0]
    s = T_all.reshape(*lead, n, hq, H // hq, Q).sum(-2)
    s = s / counts.to(torch.float32)[..., None, None] + vq_bias
    return T_all, torch.argmax(s, dim=-1).to(torch.int32)


def delta_gate_ref(x_new, x_old, threshold: float) -> torch.Tensor:
    """keep[...] = max_d |x_new − x_old| > threshold (strict), as bool.
    max, abs and > do not depend on order, so the kernel matches this
    bitwise."""
    diff = (x_new.to(torch.float32) - x_old.to(torch.float32)).abs()
    return diff.amax(dim=-1) > threshold
