"""Mixture-of-Experts (DeepSeek-V2/V3 style) — the dense path of
``repro/models/moe.py``.

``moe_apply_dense`` computes the reference's function: a softmax router in
f32, the top-k experts a token renormalized (DeepSeek), a Switch-style
load-balance aux loss, the routed SwiGLU experts weighted by their gates,
then the shared experts on every token. The reference loops over all
experts on all tokens and weights each by a mask that is 0 for unrouted
tokens; the port runs each expert only on the tokens routed to it: the
[T·k] assignments are grouped by expert with a stable sort (one host read
of the per-expert counts a call), and each expert with tokens, in ascending
order, adds its gated output into y with ``index_add_``. No token appears
twice within one expert, so the adds are deterministic and each token sums
its experts in the reference's order (the reference's unrouted ``fe · 0``
terms leave y as it is). At deepseek-v2 width the loop form would read all
160 experts' 15.1 GB a layer for every decode token. In training autograd
carries the gradient through the gates, the experts and the router's
probabilities in the aux loss; the top-k assignment counts carry none, as
in the reference.

Without a mesh the reference's ``moe_apply`` is this dense path, and so is
the port's. The expert-parallel ``moe_apply_ep`` is ROADMAP Queue A item
9d. With VQT the router's inputs are functions of quantized activations,
so ``moe_per_code`` routes and runs the experts once per codebook row of a
``core.compressed.Compressed`` tensor.

Parameter layout (each leaf with the stage's leading repeat dims):
``router [d, E]`` (f32), ``w_gate / w_up [E, d, f]``, ``w_down [E, f, d]``
and, with shared experts, ``shared.{w_gate, w_up, w_down}`` (a SwiGLU of
width ``n_shared · f``); f = ``d_ff_expert``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import normal
from repro_torch.models.ffn import ffn_apply


def moe_init(gen: torch.Generator, cfg: ArchConfig, r: tuple = ()) -> dict:
    """Parameters with leading dims ``r``, at the reference's scales."""
    e = cfg.moe
    d = cfg.d_model
    p = {
        "router": normal(gen, r + (d, e.n_experts), d ** -0.5),
        "w_gate": normal(gen, r + (e.n_experts, d, e.d_ff_expert), d ** -0.5),
        "w_up": normal(gen, r + (e.n_experts, d, e.d_ff_expert), d ** -0.5),
        "w_down": normal(gen, r + (e.n_experts, e.d_ff_expert, d), e.d_ff_expert ** -0.5),
    }
    if e.n_shared > 0:
        f = e.n_shared * e.d_ff_expert
        p["shared"] = {"w_gate": normal(gen, r + (d, f), d ** -0.5),
                       "w_up": normal(gen, r + (d, f), d ** -0.5),
                       "w_down": normal(gen, r + (f, d), f ** -0.5)}
    return p


def _router(params: dict, e, x: torch.Tensor):
    """x: [T, d] -> (gates [T, k], eidx [T, k] int64, aux_loss scalar)."""
    probs = torch.softmax(x.to(torch.float32) @ params["router"], dim=-1)
    gates, eidx = torch.topk(probs, e.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renorm (DeepSeek)
    # Switch-style load-balance loss
    frac_prob = probs.mean(0)  # [E]
    assign = F.one_hot(eidx, e.n_experts).to(torch.float32).sum(1)  # [T, E]
    frac_tok = assign.mean(0) / e.top_k
    aux = e.n_experts * torch.sum(frac_prob * frac_tok) * e.aux_loss_weight
    return gates, eidx, aux


def _expert_ffn(params: dict, i: int, xs: torch.Tensor) -> torch.Tensor:
    """Expert ``i``'s SwiGLU on xs [t, d]."""
    g = F.silu(xs @ params["w_gate"][i])
    return (g * (xs @ params["w_up"][i])) @ params["w_down"][i]


def moe_apply_dense(params: dict, cfg: ArchConfig,
                    x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [b, n, d] -> (y [b, n, d], aux): each expert on its routed tokens."""
    e = cfg.moe
    b, n, d = x.shape
    xt = x.reshape(-1, d)
    gates, eidx, aux = _router(params, e, xt)
    flat_e = eidx.reshape(-1)  # [T·k], token-major
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e.n_experts).tolist()  # the host read
    tok = order // e.top_k
    gate = gates.reshape(-1)[order].to(x.dtype)
    y = torch.zeros_like(xt)
    start = 0
    for i, cnt in enumerate(counts):
        if cnt:
            rows = tok[start:start + cnt]
            y.index_add_(0, rows, _expert_ffn(params, i, xt[rows]) * gate[start:start + cnt, None])
            start += cnt
    if "shared" in params:
        y = y + ffn_apply("swiglu", params["shared"], xt)
    return y.reshape(b, n, d), aux


def moe_apply(params: dict, cfg: ArchConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply`` without a mesh: the dense path."""
    return moe_apply_dense(params, cfg, x)


def moe_per_code(params: dict, cfg: ArchConfig, c):
    """MoE over a *compressed* activation tensor (``core.compressed``):
    identical VQ codes route identically, so routing and the experts run
    once per codebook row — O(q) instead of O(b·n) expert compute across a
    batch of revisions. Returns (Compressed y, aux)."""
    from repro_torch.core.compressed import Compressed

    y_rows, aux = moe_apply_dense(params, cfg, c.codebook[None])
    return Compressed(y_rows[0], c.idx, c.n_codes), aux
