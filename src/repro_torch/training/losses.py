"""Training losses — the port of ``repro/training/losses.py``: next-token
LM, distillation (Sanh et al. 2020) and classification. Log-softmax in
f32."""
from __future__ import annotations

from typing import Optional

import torch


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x.to(torch.float32), dim=-1)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [b, n, V] (audio: [b, n, cb, V]); tokens [b, n] (or
    [b, n, cb]). Predict token t + 1 from position t; with ``mask`` [b, n]
    the mean over the targets it keeps."""
    logp = _log_softmax(logits[:, :-1])
    targets = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if nll.dim() == 3:  # audio codebooks: average over the codebook axis
        nll = nll.mean(-1)
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 tokens: torch.Tensor, *, alpha_ce: float = 5.0, alpha_lm: float = 2.0,
                 temperature: float = 2.0) -> tuple[torch.Tensor, dict]:
    """DistilBERT-style loss: KL(teacher‖student) at ``temperature`` plus the
    hard LM loss (paper §4 follows Sanh et al. 2020). Returns (loss,
    {"kl", "lm"})."""
    t = temperature
    s_logp = _log_softmax(student_logits[:, :-1] / t)
    t_logp = _log_softmax(teacher_logits[:, :-1] / t)
    t_p = torch.exp(t_logp)
    kl = torch.sum(t_p * (t_logp - s_logp), dim=-1).mean() * t * t
    lm = next_token_loss(student_logits, tokens)
    return alpha_ce * kl + alpha_lm * lm, {"kl": kl, "lm": lm}


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """logits [b, C]; labels [b]. Returns (loss, accuracy)."""
    logp = _log_softmax(logits)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return torch.mean(nll), acc
