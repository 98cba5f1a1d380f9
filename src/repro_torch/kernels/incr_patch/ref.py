"""Plain PyTorch version of the incremental column-patch kernel
(``csrc/incr_patch.cu``), the port of ``repro/kernels/incr_patch/ref.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def incr_patch_ref(q, k_new, k_old, vc_new, vc_old, mask) -> torch.Tensor:
    """q: [..., R, H, dh]; k_*: [..., H, C, dh]; vc_*: [..., H, C, Q];
    mask: [..., R, C]. Returns ΔT [..., R, H, Q] f32 = the new columns'
    contribution minus the old ones'."""
    scale = q.shape[-1] ** -0.5
    w_mask = mask.to(torch.float32).unsqueeze(-2)  # [..., R, 1, C]

    def contrib(k, vc):
        s = torch.einsum("...rhd,...hcd->...rhc", q.to(torch.float32),
                         k.to(torch.float32)) * scale
        w = F.gelu(s, approximate="tanh") * w_mask
        return torch.einsum("...rhc,...hcq->...rhq", w, vc.to(torch.float32))

    return contrib(k_new, vc_new) - contrib(k_old, vc_old)
