"""Multi-head vector quantization (paper §3 eq. 1, §4) — the inference
half of ``repro/core/vq.py``: ``VQConfig``, ``init``, ``scores``,
``assign``, ``lookup`` and ``quantize``. Assignment uses the inner-product
form of the Euclidean distance (App. A.2): ``argmin ‖x − c‖² == argmax
(x·c − ‖c‖²/2)``. ``quantize`` runs the ``vq_assign`` kernel; training-mode
VQ (Gumbel straight-through) comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
