"""Dense feed-forward blocks — ``ffn_apply`` of ``repro/models/ffn.py``:
the gated SwiGLU and GeGLU (no biases) and the biased GELU, ReLU and
squared-ReLU MLPs. GELU is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
