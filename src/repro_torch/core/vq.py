"""Multi-head vector quantization (paper §3 eq. 1, §4) — the port of
``repro/core/vq.py``: ``VQConfig``, ``init``, ``scores``, ``assign``,
``lookup``, ``quantize`` and the training-mode ``forward_train``.
Assignment uses the inner-product form of the Euclidean distance (App.
A.2): ``argmin ‖x − c‖² == argmax (x·c − ‖c‖²/2)``. ``quantize`` runs the
``vq_assign`` kernel; ``forward_train`` computes its scores in plain code,
as the reference does, for the Gumbel-softmax straight-through estimator
(paper §4) with a commitment term (van den Oord et al. 2017).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.vq_assign import vq_assign


@dataclass(frozen=True)
class VQConfig:
    n_heads: int = 2
    codebook_size: int = 64
    commitment_beta: float = 0.25
    # Gumbel-softmax temperature used during training.
    temperature: float = 1.0


def init(gen: torch.Generator, d_model: int, cfg: VQConfig, repeat: tuple = ()) -> dict:
    """A layer's ``{"codebook": [*repeat, hq, Q, d_model / hq]}``: normals
    times 0.5 (the scale of normalized activations), drawn on the
    generator's device, with leading ``repeat`` dims (a stage's layers)."""
    if d_model % cfg.n_heads:
        raise ValueError(f"d_model={d_model} not divisible by vq heads={cfg.n_heads}")
    shape = repeat + (cfg.n_heads, cfg.codebook_size, d_model // cfg.n_heads)
    return {"codebook": torch.randn(shape, generator=gen, dtype=torch.float32,
                                    device=gen.device).mul_(0.5)}


# ---------------------------------------------------------------- inference
# ``params`` is the layer's ``mixer.vq`` dict: {"codebook": [hq, Q, dv]}.


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)


def scores(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Negative-distance scores per head: [..., n_heads, codebook_size],
    ``score[c] = x·C_c − ‖C_c‖²/2`` (monotone in −‖x − C_c‖²)."""
    cb = params["codebook"].to(torch.float32)
    xh = _split_heads(x, cb.shape[0]).to(torch.float32)
    return torch.einsum("...hd,hqd->...hq", xh, cb) - 0.5 * (cb ** 2).sum(-1)


def assign(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices per head: int32 [..., n_heads]."""
    return torch.argmax(scores(params, x), dim=-1).to(torch.int32)


def lookup(params: dict, idx: torch.Tensor) -> torch.Tensor:
    """Gather codebook vectors: idx [..., n_heads] -> [..., d_model]."""
    cb = params["codebook"]
    heads = torch.arange(cb.shape[0], device=cb.device)
    return cb[heads, idx.long()].reshape(*idx.shape[:-1], -1)


def quantize(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard quantization (inference) through the ``vq_assign`` kernel — its
    plain version on CPU tensors. Returns (x_q, idx)."""
    idx, x_q = vq_assign(x, params["codebook"])
    return x_q.to(x.dtype), idx


# ---------------------------------------------------------------- training


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log u)``, u uniform in [tiny, 1) (as
    ``jax.random.gumbel``), drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def forward_train(params: dict, x: torch.Tensor, cfg: VQConfig, *,
                  noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode VQ with the Gumbel-softmax straight-through estimator
    (``repro/core/vq.py:114-148``). ``noise`` is Gumbel noise of the scores'
    shape [..., n_heads, codebook_size] (a test passes the reference's);
    else it is drawn from ``generator``; with neither, no noise.

    Returns (x_st, idx, aux): ``x_st`` is x_q in value and carries the
    gradient to x unchanged; the codebook gets its gradient through the
    codebook term and the soft assignment weights; ``aux`` = β·commitment +
    codebook loss."""
    s = scores(params, x)  # [..., h, q]
    if noise is None and generator is not None:
        noise = gumbel(generator, s.shape)
    logits = (s + noise.to(s.device)) / cfg.temperature if noise is not None \
        else s / cfg.temperature
    soft = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1).to(torch.int32)
    hard = F.one_hot(idx.long(), s.shape[-1]).to(soft.dtype)
    # straight-through on the assignment weights
    w = hard + soft - soft.detach()
    cb = params["codebook"]
    xq_h = torch.einsum("...hq,hqd->...hd", w, cb.to(w.dtype))
    merged = xq_h.reshape(*xq_h.shape[:-2], -1)
    x_q = merged.to(x.dtype)
    # commitment: pull the encoder outputs toward their codes
    hard_q = lookup(params, idx).to(torch.float32).detach()
    commit = torch.mean((x.to(torch.float32) - hard_q) ** 2)
    # codebook loss: pull the codes toward the (stopped) encoder outputs
    codebook_loss = torch.mean((merged.to(torch.float32) - x.to(torch.float32).detach()) ** 2)
    aux = cfg.commitment_beta * commit + codebook_loss
    # straight-through on the values as well (the gradient reaches x unchanged)
    return x + (x_q - x).detach(), idx, aux
