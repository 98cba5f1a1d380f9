"""Plain PyTorch version of the VQ assignment kernel (``csrc/vq_assign.cu``),
the port of ``repro/kernels/vq_assign/ref.py``: scores in the inner-product
form ``x·C − ‖C‖²/2`` (paper App. A.2), the first maximum over the codebook,
and the winning codebook rows. The wrappers in ``ops.py`` run it for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernel against it."""
from __future__ import annotations

import torch


def codebook_bias(codebook: torch.Tensor) -> torch.Tensor:
    """−‖C‖²/2 per code: [hq, Q, dv] -> [hq, Q] f32. The CUDA kernel
    computes the same bias itself, in another summation order; the card
    checks excuse an index only where the top-two scores lie within 1e-4."""
    return -0.5 * (codebook.to(torch.float32) ** 2).sum(-1)


def vq_assign_ref(xh: torch.Tensor, codebook: torch.Tensor):
    """xh: [..., hq, dv]; codebook: [hq, Q, dv] -> (idx [..., hq] int32,
    xq [..., hq, dv]) with ``xq = codebook[h, idx]``."""
    scores = (torch.einsum("...hd,hqd->...hq", xh.to(torch.float32),
                           codebook.to(torch.float32))
              + codebook_bias(codebook))
    idx = torch.argmax(scores, dim=-1)  # first maximum on ties
    heads = torch.arange(codebook.shape[0], device=codebook.device)
    return idx.to(torch.int32), codebook[heads, idx].to(xh.dtype)
