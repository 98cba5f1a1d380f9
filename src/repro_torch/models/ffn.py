"""Dense feed-forward blocks — the biased (OPT-style) variants of
``repro/models/ffn.py``. GELU is the tanh approximation, as the reference's
``jax.nn.gelu(approximate=True)``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ffn_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind != "gelu":
        raise ValueError(f"the port has no {kind!r} FFN yet (model-family slice)")
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]
