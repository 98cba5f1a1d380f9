"""Dense feed-forward blocks — ``ffn_init`` and ``ffn_apply`` of
``repro/models/ffn.py``: the gated SwiGLU and GeGLU (no biases) and the
biased GELU, ReLU and squared-ReLU MLPs. GELU is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import normal


def ffn_init(gen: torch.Generator, kind: str, d: int, d_ff: int, r: tuple = ()) -> dict:
    """Parameters of a ``kind`` block with leading dims ``r``, at the
    reference's scales (its draws come from ``jax.random``, these from
    ``gen``)."""
    if kind in ("swiglu", "geglu"):
        return {"w_gate": normal(gen, r + (d, d_ff), d ** -0.5),
                "w_up": normal(gen, r + (d, d_ff), d ** -0.5),
                "w_down": normal(gen, r + (d_ff, d), d_ff ** -0.5)}
    if kind in ("gelu", "relu", "relu2"):
        return {"w_up": normal(gen, r + (d, d_ff), d ** -0.5),
                "b_up": torch.zeros(r + (d_ff,)),
                "w_down": normal(gen, r + (d_ff, d), d_ff ** -0.5),
                "b_down": torch.zeros(r + (d,))}
    raise ValueError(kind)


def ffn_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        g = F.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    if kind == "geglu":
        g = F.gelu(x @ params["w_gate"], approximate="tanh")
        return (g * (x @ params["w_up"])) @ params["w_down"]
    if kind in ("gelu", "relu", "relu2"):
        h = x @ params["w_up"] + params["b_up"]
        if kind == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif kind == "relu":
            h = F.relu(h)
        else:
            h = F.relu(h) ** 2
        return h @ params["w_down"] + params["b_down"]
    raise ValueError(kind)
