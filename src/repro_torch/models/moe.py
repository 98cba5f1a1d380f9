"""Mixture-of-Experts (DeepSeek-V2/V3 style) — ``repro/models/moe.py`` on
the port.

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

``moe_apply_ep`` is the reference's expert-parallel path over the
``"model"`` axis of the active grid (``distributed.context.use_mesh``).
The reference maps a function over the mesh with ``shard_map``; the port
loops over the grid's data rows and model indices, each slice on its grid
entry's device: a fixed-capacity dispatch (cumsum slotting, assignments
past ``capacity_factor`` dropped), the ``all_to_all`` as copies of
``[E_loc, cap, d]`` blocks to the experts' owners, one grouped product a
owner, the copies back, the gates (``moe_ep_row`` a data row, which
``models.sharded`` calls with each row's tokens where they sit).
``moe_apply`` is ``moe_apply_ep``, as in the reference, so it is the
dense path whenever no grid is active.
``place_experts`` lays the expert stacks out once by the grid's plan
(``launch.sharding``), each slice resident on its device.

With VQT the router's inputs are functions of quantized activations,
so ``moe_per_code`` routes and runs the experts once per codebook row of a
``core.compressed.Compressed`` tensor.

Parameter layout (each leaf with the stage's leading repeat dims):
``router [d, E]`` (f32), ``w_gate / w_up [E, d, f]``, ``w_down [E, f, d]``
and, with shared experts, ``shared.{w_gate, w_up, w_down}`` (a SwiGLU of
width ``n_shared · f``); f = ``d_ff_expert``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import get_ctx, grid_index_rows
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


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _ep_capacity(t2: int, e, n_experts: int) -> int:
    cap = int(math.ceil(t2 * e.top_k / n_experts * e.capacity_factor))
    return max(8, cap)


@dataclass
class ExpertPlacement:
    """The expert stacks laid out by a grid's plan: ``experts[(m, device)]``
    holds model index m's ``[E/M, ...]`` slices of the three expert leaves
    on ``device``; ``router[device]`` the replicated router."""
    grid: object
    experts: dict
    router: dict


def place_experts(params: dict, grid) -> dict:
    """``params`` with its expert stacks placed once on ``grid`` by
    ``launch.sharding``'s plan (``P("model", None, None)``: slice m of the
    experts on every entry of model index m, copied there) and the router
    replicated on each device. The returned dict holds no whole expert
    leaf, so the caller may free the originals; ``moe_apply_ep`` under
    ``use_mesh(grid)`` reads the slices where they sit."""
    from repro_torch.distributed.context import NamedSharding, PartitionSpec as P

    names = grid.axis_names
    spec = P("model", None, None) if "model" in names else P(None, None, None)
    m_axis = names.index("model") if "model" in names else None
    experts: dict = {}
    for name in _EXPERT_LEAVES:
        leaf = params[name]
        for idx, sl in NamedSharding(grid, spec).blocks(tuple(leaf.shape)).items():
            dev = torch.device(grid.devices[idx])
            slot = experts.setdefault((0 if m_axis is None else idx[m_axis], dev), {})
            if name not in slot:
                slot[name] = leaf[sl].to(dev, copy=True)
    router = {}
    for dev in grid.devices.flat:
        dev = torch.device(dev)
        if dev not in router:
            router[dev] = params["router"].to(dev, copy=True)
    out = {k: v for k, v in params.items() if k not in _EXPERT_LEAVES}
    out["placed"] = ExpertPlacement(grid=grid, experts=experts, router=router)
    return out


def _slice_weights(params: dict, m: int, dev: torch.device, E_loc: int) -> tuple:
    """Model index m's expert slices on ``dev``: from the placement, or
    sliced from the whole leaves (a view where they already sit on ``dev``)."""
    placed = params.get("placed")
    if placed is not None:
        w = placed.experts[(m, dev)]
        return tuple(w[k] for k in _EXPERT_LEAVES)
    sl = slice(m * E_loc, (m + 1) * E_loc)
    return tuple(params[k][sl].to(dev) for k in _EXPERT_LEAVES)


def _router_on(params: dict, dev: torch.device) -> dict:
    placed = params.get("placed")
    return {"router": placed.router[dev] if placed is not None else params["router"].to(dev)}


# what the expert-parallel calls moved since ``reset_ep_stats``: calls;
# bytes of the [E_loc, cap, d] blocks exchanged between distinct grid
# entries (the reference's two all_to_alls); bytes that crossed between
# distinct devices (tokens out and back, blocks); and the last call's kept
# assignments a slice, by (data row, model index): [T2·k] bool tensors,
# token-major, False where an assignment was dropped
EP_STATS: dict = {}


def reset_ep_stats() -> None:
    EP_STATS.update(calls=0, exchange_bytes=0, device_copy_bytes=0, kept={})


reset_ep_stats()


def _grouped_ffn(w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """xs [E_loc, C, d] grouped tokens; weights [E_loc, ...]."""
    g = F.silu(torch.bmm(xs, w_gate))
    return torch.bmm(g * torch.bmm(xs, w_up), w_down)


def moe_apply_ep(params: dict, cfg: ArchConfig,
                 x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the active grid; the dense path without one.
    x [b, n, d] -> (y [b, n, d] on x's device, aux).

    For data row r (b/D documents) and model index m, on device
    ``grid[r, m]``: the row's tokens padded to T2·M, slice m's T2 tokens
    routed, and each assignment slotted into its expert's bucket by an
    exclusive cumsum in token-major order (the reference's); those at or
    past ``cap`` are dropped (they go to a dump slot, never index −1). The
    [E, cap, d] buckets go to the owners as [E_loc, cap, d] blocks; owner j
    runs its experts once over [E_loc, M·cap, d] and sends each slice its
    block back, where the gated outputs are summed a token. The shared
    experts run on each row's tokens in full (the dense function: the
    reference's ``shard_map`` adds only each model slice's share of them,
    which at M > 1 drops (M−1)/M of their output). aux is the mean of the
    slices' aux, as the reference's. Differentiable: the copies between
    devices, index copies and gathers all carry gradients."""
    ctx = get_ctx()
    if ctx is None:
        return moe_apply_dense(params, cfg, x)
    b = x.shape[0]
    idx_rows = grid_index_rows(ctx.mesh)
    D = len(idx_rows)
    if b % D:
        raise ValueError(f"batch {b} does not split over the {D} data rows of {ctx.mesh}")
    placed = params.get("placed")
    if placed is not None and not (placed.grid.axis_names == ctx.mesh.axis_names
                                   and np.array_equal(placed.grid.devices, ctx.mesh.devices)):
        raise ValueError(f"experts are placed on {placed.grid}, not on the active {ctx.mesh}")
    b_loc = b // D
    home = x.device
    ys, auxes = [], []
    for r, idxs in enumerate(idx_rows):
        xb = x[r * b_loc:(r + 1) * b_loc]
        y, aux = moe_ep_row(params, cfg, xb, r, ctx.mesh, idxs, home=home)
        ys.append(y)
        auxes.extend(aux)
    EP_STATS["calls"] += 1
    return torch.cat(ys), torch.stack(auxes).mean()


def moe_ep_row(params: dict, cfg: ArchConfig, xb: torch.Tensor, r: int, grid, idxs: list,
               home=None, shared=None) -> tuple[torch.Tensor, list]:
    """Data row ``r`` of ``moe_apply_ep``: its tokens ``xb`` [b_loc, n, d]
    over the row's model slices (grid indices ``idxs``). The weights are
    whole leaves, a ``place_experts`` placement, or ``Blocks`` (each
    slice's block on its entry). ``shared`` runs the shared experts (default
    ``ffn_apply`` on xb). Returns (y [b_loc, n, d] on ``home``, default
    xb's device; the slices' aux on ``home``)."""
    from repro_torch.distributed.context import Blocks, at_entry, move

    e = cfg.moe
    b_loc, n, d = xb.shape
    E, k = e.n_experts, e.top_k
    M = len(idxs)
    if E % M:
        raise ValueError(f"experts {E} must divide model axis {M}")
    E_loc = E // M
    T_loc = b_loc * n
    T2 = -(-T_loc // M)  # tokens each model slice is responsible for
    cap = _ep_capacity(T2, e, E)
    block = E_loc * cap * d * xb.element_size()
    home = xb.device if home is None else home
    devs = [torch.device(grid.devices[i]) for i in idxs]
    src = next((i for i, dv in zip(idxs, devs) if dv == xb.device), idxs[0])
    blocks = isinstance(params["router"], Blocks)

    def weights(j):
        if blocks:
            return tuple(params[name].block(idxs[j]) for name in _EXPERT_LEAVES)
        return _slice_weights(params, j, devs[j], E_loc)

    def router(m):
        if blocks:
            return {"router": params["router"].block(idxs[m])}
        return _router_on(params, devs[m])

    x2 = xb.reshape(T_loc, d)
    xt = torch.cat([x2, x2.new_zeros(T2 * M - T_loc, d)]) if T2 * M > T_loc else x2
    sends, slots, auxes = [], [], []
    for m, dev in enumerate(devs):
        x_mine = move(xt[m * T2:(m + 1) * T2], src, idxs[m], grid, "model_bcast")
        with at_entry(idxs[m]):
            gates, eidx, aux = _router(router(m), e, x_mine)
            flat_e = eidx.reshape(-1)  # [T2·k], token-major
            onehot = F.one_hot(flat_e, E)
            pos = ((onehot.cumsum(0) - onehot) * onehot).sum(1)  # place in the bucket
            keep = pos < cap
            dst = flat_e * (cap + 1) + torch.where(keep, pos, torch.full_like(pos, cap))
            rep = x_mine[:, None].expand(T2, k, d).reshape(T2 * k, d)
            buf = x_mine.new_zeros(E * (cap + 1), d).index_copy(0, dst, rep)
            sends.append(buf.view(E, cap + 1, d)[:, :cap].reshape(M, E_loc, cap, d))
        slots.append((dst, gates))
        auxes.append(aux.to(home))
        EP_STATS["kept"][(r, m)] = keep
        EP_STATS["device_copy_bytes"] += (T2 * d * xb.element_size()) * 2 * (dev != home)
    outs = []
    for j, dev in enumerate(devs):  # owner j: its experts over every slice's block
        grouped = torch.stack([move(sends[m][j], idxs[m], idxs[j], grid, "expert_all_to_all")
                               for m in range(M)], 1)
        with at_entry(idxs[j]):
            outs.append(_grouped_ffn(*weights(j), grouped.reshape(E_loc, M * cap, d))
                        .view(E_loc, M, cap, d))
    parts = []
    for m, dev in enumerate(devs):
        ret = torch.cat([move(outs[j][:, m], idxs[j], idxs[m], grid, "expert_all_to_all")
                         for j in range(M)])  # [E, cap, d]
        dst, gates = slots[m]
        with at_entry(idxs[m]):
            ret = torch.cat([ret, ret.new_zeros(E, 1, d)], 1).view(E * (cap + 1), d)
            vals = ret.index_select(0, dst) * gates.reshape(-1, 1).to(ret.dtype)
        parts.append(move(vals.view(T2, k, d).sum(1), idxs[m], src, grid, "model_gather")
                     .to(home))
    EP_STATS["exchange_bytes"] += 2 * M * (M - 1) * block
    EP_STATS["device_copy_bytes"] += 2 * block * sum(
        devs[m] != devs[j] for m in range(M) for j in range(M))
    y = torch.cat(parts)[:T_loc].view(b_loc, n, d)
    if "shared" in params:
        y = y + (shared(xb) if shared is not None
                 else ffn_apply("swiglu", params["shared"], xb)).to(home)
    return y, auxes


def moe_apply(params: dict, cfg: ArchConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``moe_apply``: expert-parallel under a grid, dense
    without one."""
    return moe_apply_ep(params, cfg, x)


def moe_per_code(params: dict, cfg: ArchConfig, c):
    """MoE over a *compressed* activation tensor (``core.compressed``):
    identical VQ codes route identically, so routing and the experts run
    once per codebook row — O(q) instead of O(b·n) expert compute across a
    batch of revisions. Returns (Compressed y, aux)."""
    from repro_torch.core.compressed import Compressed

    y_rows, aux = moe_apply_dense(params, cfg, c.codebook[None])
    return Compressed(y_rows[0], c.idx, c.n_codes), aux
