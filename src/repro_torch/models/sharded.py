"""The attention-stack families' forward and LM loss run by the sharding
plan across a grid (``launch.sharding``) — what ``jax.jit`` with the
reference's ``in_shardings`` does on its mesh (``repro/launch/train.py:
57-66``), as an eager loop over the grid's entries.

The batch splits over the data rows (the "pod" and "data" axes); within a
row, the model axis runs Megatron-style tensor parallelism:

* a row's residual stream, its norms, the replicated projections (MLA's
  ``w_dq`` / ``w_dkv``, MTP's ``proj``) and the VQ hook run once, on the
  row's first entry (its "home");
* a column-split weight (``wq``, ``wk``, ``wv``, ``w_uq`` / ``w_uk`` /
  ``w_uv``, ``w_gate`` / ``w_up``, ``lm_head``) runs on each entry over
  the row's activation copied there ("model_bcast");
* each entry computes attention over whole heads, H·m/M .. H·(m+1)/M, and
  gathers the q / k / v columns they need from the entries that computed
  them ("model_gather": a plan splits columns, and 32 columns of a
  64-wide kv head or 1.5 of phi4-mini's 128-wide heads are common); GQA kv
  heads are mapped to the entry's q heads whether or not Hkv divides M;
* the VQ runs on whole VQ heads: the heads' outputs gathered at home, the
  quantized columns handed to the entries holding ``wo``'s rows;
* a row-split weight (``wo``, ``w_down``) gives partial sums that add over
  the model axis at home ("model_sum"), and its bias is added once;
* the vocab-split embedding looks up the in-range ids on each entry (the
  others masked to 0, never an index out of range) and sums over model;
* the loss is a vocab-parallel cross-entropy: each entry's max, sum of
  exponentials and target logit over its vocab block, combined over model
  (3 floats a token an entry, where gathering the logits would move
  (M − 1)/M of b·n·V floats);
* MoE layers go through ``moe.moe_ep_row`` with the row's tokens;
* rwkv6's time mix: the token shift and the five stream mixes at home,
  ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` by columns, each entry's WKV scan,
  decay LoRA columns (its columns of ``w_dec_b``, ``w0`` and ``u``) and
  per-head GroupNorm over its whole heads, ``w_o`` by rows; the channel
  mix's ``relu²(xk·w_k)·w_v`` a row-split partial sum and its
  ``sigmoid(xr·w_r)`` gathered at home before the product;
* hymba's attention branch as GQA's; its SSM branch conv'd on each
  ``conv_w`` block over the ``x`` columns of ``w_xz`` (split by columns
  of the concatenation ``x | z``, so the columns are gathered), each
  entry scanning its whole SSM heads with ``B`` / ``C`` / ``dt`` from
  home; both branches' RMSNorms, the VQ and the fuse at home.

A leaf replicated over the model axis is read only at home, so the
gradient of each of its copies, summed over the copies
(``context.reduce_replicas``), is the leaf's gradient. A tree of whole
leaves is laid out on the fly (``sharding.lay_out``, differentiable), so
its gradients are whole leaves. A replicated leaf that an entry needs a
slice of (rwkv6's ``w_dec_b`` columns) is read from that entry's own
copy: the copies' gradients still sum to the leaf's. Every layer runs
under ``at_entry`` of the entry that computes it, for the dry run's
count. ``models.sharded_decode`` runs the decode step on these rows,
against caches laid out by ``launch.sharding.place_caches``.
"""
from __future__ import annotations

import contextlib
import threading
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.core import vq as vq_mod
from repro_torch.distributed.context import (
    Blocks, active_grid, at_entry, count_bytes, get_ctx, grid_index_rows, move, sum_to,
    with_ctx,
)
from repro_torch.models import moe
from repro_torch.models.attention import apply_rope, full_attention
from repro_torch.models.hymba import _causal_conv
from repro_torch.models.linear_scan import (
    CHUNK, lin_attn_chunked, lin_attn_decode_step,
)
from repro_torch.models.mla import mla_core
from repro_torch.models.norms import apply_norm, groupnorm, rmsnorm
from repro_torch.models.rwkv6 import _token_shift


class Row:
    """Data row ``r`` of a grid: its entries ``idx`` (by model index) and
    their devices; entry 0 is the row's home."""

    def __init__(self, grid, r: int, idx: list):
        self.grid, self.r, self.idx = grid, r, idx
        self.M = len(idx)
        self.devs = [torch.device(grid.devices[i]) for i in idx]

    @property
    def home(self) -> torch.device:
        return self.devs[0]

    def at(self, m: int):
        return at_entry(self.idx[m])

    def scatter(self, t: torch.Tensor) -> "Scattered":
        return Scattered(self, t)

    def sum_model(self, parts: list) -> torch.Tensor:
        """[(model index, tensor)] summed at home."""
        return sum_to([(self.idx[m], t) for m, t in parts], self.idx[0], self.grid, "model_sum")


class Scattered:
    """A home tensor's copy on each entry of its row, made on first use."""

    def __init__(self, row: Row, t: torch.Tensor):
        self.row, self.t, self.on = row, t, {}

    def __getitem__(self, m: int) -> torch.Tensor:
        if m not in self.on:
            row = self.row
            self.on[m] = move(self.t, row.idx[0], row.idx[m], row.grid, "model_bcast")
        return self.on[m]


def rows_of(grid) -> list:
    return [Row(grid, r, idx) for r, idx in enumerate(grid_index_rows(grid))]


_only = threading.local()


@contextlib.contextmanager
def first_row_only():
    """Run only data row 0 of the grid (its share of the batch): the dry
    run's symmetry, every data row doing the same work. The loss is then
    row 0's part of it."""
    prev = getattr(_only, "on", False)
    _only.on = True
    try:
        yield
    finally:
        _only.on = prev


def at_home(tree, row: Row):
    """A small subtree (norms) with every ``Blocks`` leaf as its home block."""
    if isinstance(tree, dict):
        return {k: at_home(v, row) for k, v in tree.items()}
    return tree.block(row.idx[0]) if isinstance(tree, Blocks) else tree


def owners(w: Blocks, row: Row, axis: int) -> list:
    """[(model index, lo, hi)]: the range of ``w``'s dimension ``axis``
    each entry of the row holds — M equal blocks when the plan splits it
    over "model", else all of it at home."""
    size = w.shape[axis]
    spec = tuple(w.sharding.spec) + (None,) * (len(w.shape) - len(w.sharding.spec))
    entry = spec[axis]
    if entry is not None and "model" in (entry if isinstance(entry, tuple) else (entry,)):
        step = size // row.M
        return [(m, m * step, (m + 1) * step) for m in range(row.M)]
    return [(0, 0, size)]


def col_project(row: Row, xs: Scattered, w: Blocks, b: Optional[Blocks] = None) -> list:
    """x @ w (+ b) by ``w``'s column blocks: [(model index, first column,
    block's columns on that entry)]."""
    pieces = []
    for m, lo, _ in owners(w, row, -1):
        with row.at(m):
            y = xs[m] @ w.block(row.idx[m])
            if b is not None:
                y = y + b.block(row.idx[m])
        pieces.append((m, lo, y))
    return pieces


def gather_range(grid, pieces: list, dst, lo: int, hi: int, kind: str,
                 dim: int = -1) -> torch.Tensor:
    """[lo, hi) of dimension ``dim`` of the tensor that ``pieces`` ([(grid
    index, first index, piece)]) partition, on grid entry ``dst``: a piece
    there as it is, the rest moved under ``kind``."""
    parts = []
    for src, plo, t in pieces:
        size = t.shape[dim]
        a, z = max(lo, plo), min(hi, plo + size)
        if a < z:
            part = t if (a, z) == (plo, plo + size) else t.narrow(dim, a - plo, z - a)
            parts.append(move(part, src, dst, grid, kind))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def take_cols(row: Row, pieces: list, m: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) (the last dim) of the tensor that ``pieces``
    partition, on entry m: its own piece as it is, the rest gathered."""
    return gather_range(row.grid, [(row.idx[j], plo, t) for j, plo, t in pieces], row.idx[m],
                        lo, hi, "model_gather")


def row_project_sum(row: Row, pieces: list, w: Blocks, b: Optional[Blocks] = None):
    """(the columns ``pieces`` partition) @ w by ``w``'s row blocks, the
    partial products summed over model at home, + b once."""
    parts = []
    for m, lo, hi in owners(w, row, 0):
        with row.at(m):
            parts.append((m, take_cols(row, pieces, m, lo, hi) @ w.block(row.idx[m])))
    with row.at(0):
        y = row.sum_model(parts)
        return y if b is None else y + b.block(row.idx[0])


def heads_of(row: Row, m: int, H: int) -> tuple[int, int]:
    """Entry m's heads [h0, h1): whole heads, as even as H allows."""
    return H * m // row.M, H * (m + 1) // row.M


# ---------------------------------------------------------------- layers


def embed_rows(E: dict, cfg: ArchConfig, row: Row, tokens: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """``embedding.embed_tokens`` on the row: each entry looks up the ids in
    its vocab block ([cb, V/M, d] per codebook for audio), the others 0,
    summed over model at home; positions added at home."""
    tok = E["tok"]
    audio = cfg.n_codebooks > 1
    own = owners(tok, row, 1 if audio else 0)
    ts = row.scatter(tokens)
    parts = []
    for m, lo, hi in own:
        with row.at(m):
            w, ids = tok.block(row.idx[m]), ts[m].long()

            def look(table, i):
                if len(own) == 1:
                    return table[i]
                local = i - lo
                ok = (local >= 0) & (local < hi - lo)
                return torch.where(ok[..., None], table[local.clamp(0, hi - lo - 1)], 0.0)

            e = (sum(look(w[c], ids[..., c]) for c in range(cfg.n_codebooks)) if audio
                 else look(w, ids))
        parts.append((m, e))
    with row.at(0):
        x = row.sum_model(parts)
        if cfg.pos in ("learned", "sampled"):
            x = x + E["pos"].block(row.idx[0])[positions.long()]
    return x


def ffn_rows(kind: str, p: dict, row: Row, h: torch.Tensor) -> torch.Tensor:
    """``ffn.ffn_apply`` on the row: w_gate / w_up (and b_up) by columns,
    w_down by rows, summed over model, b_down once."""
    xs = row.scatter(h)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else partial(F.gelu, approximate="tanh")
        hid = []
        for (m, lo, g), (_, _, u) in zip(col_project(row, xs, p["w_gate"]),
                                         col_project(row, xs, p["w_up"])):
            with row.at(m):
                hid.append((m, lo, act(g) * u))
    elif kind in ("gelu", "relu", "relu2"):
        hid = []
        for m, lo, u in col_project(row, xs, p["w_up"], p["b_up"]):
            with row.at(m):
                if kind == "gelu":
                    u = F.gelu(u, approximate="tanh")
                elif kind == "relu":
                    u = F.relu(u)
                else:
                    u = F.relu(u) ** 2
            hid.append((m, lo, u))
    else:
        raise ValueError(kind)
    return row_project_sum(row, hid, p["w_down"], p.get("b_down"))


def _vq_and_mix(p: dict, cfg: ArchConfig, row: Row, outs: list, width: int, train: bool,
                vq_noise) -> tuple[torch.Tensor, torch.Tensor]:
    """The heads' outputs ``outs`` (pieces of [b, n, width]) through the VQ
    hook on whole VQ heads at home, then ``wo`` by rows (+ ``bo`` once)."""
    aux = None
    if "vq" in p:
        o = take_cols(row, outs, 0, 0, width)
        with row.at(0):
            vq = {"codebook": p["vq"]["codebook"].block(row.idx[0])}
            if train:
                o, _, aux = vq_mod.forward_train(vq, o, cfg.vqt, noise=vq_noise)
            else:
                o = vq_mod.quantize(vq, o)[0]
        outs = [(0, 0, o)]
    y = row_project_sum(row, outs, p["wo"], p.get("bo"))
    return y, (torch.zeros((), device=row.home) if aux is None else aux)


def attn_heads(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, xs: Scattered,
               ps: Scattered) -> list:
    """Full attention on the row (σ through the ``gated_attention`` kernel
    on each entry's device, softmax plain): [(model index, first column,
    its whole heads' outputs)]."""
    b, n, _ = xs.t.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rep = H // Hkv
    qp = col_project(row, xs, p["wq"], p.get("bq"))
    kp = col_project(row, xs, p["wk"], p.get("bk"))
    vp = col_project(row, xs, p["wv"], p.get("bv"))
    outs = []
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        kv0, kv1 = h0 // rep, (h1 - 1) // rep + 1
        with row.at(m):
            q = take_cols(row, qp, m, h0 * dh, h1 * dh).reshape(b, n, h1 - h0, dh)
            k = take_cols(row, kp, m, kv0 * dh, kv1 * dh).reshape(b, n, kv1 - kv0, dh)
            v = take_cols(row, vp, m, kv0 * dh, kv1 * dh).reshape(b, n, kv1 - kv0, dh)
            if cfg.pos == "rope":
                q = apply_rope(q, ps[m], cfg.rope_theta)
                k = apply_rope(k, ps[m], cfg.rope_theta)
            if rep > 1:  # the kv head of each of the entry's q heads
                sel = torch.tensor([hh // rep - kv0 for hh in range(h0, h1)],
                                   device=row.devs[m])
                k, v = k.index_select(2, sel), v.index_select(2, sel)
            o = full_attention(q, k, v, causal=True, window=layer.window,
                               softmax=cfg.attn_softmax)
        outs.append((m, h0 * dh, o))
    return outs


def attn_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
              positions: torch.Tensor, *, train: bool, vq_noise) -> tuple:
    """``attention.attn_apply`` on the row."""
    outs = attn_heads(p, cfg, layer, row, row.scatter(h), row.scatter(positions))
    return _vq_and_mix(p, cfg, row, outs, cfg.n_heads * cfg.resolved_head_dim, train, vq_noise)


def mla_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
             positions: torch.Tensor, *, train: bool, vq_noise) -> tuple:
    """``mla.mla_apply`` on the row: the latents at home (``w_dq`` and
    ``w_dkv`` replicated), the up-projections by columns, each entry's
    whole heads."""
    m_ = cfg.mla
    b, n, _ = h.shape
    H = cfg.n_heads
    qk = m_.nope_dim + m_.rope_dim
    with row.at(0):
        cq = rmsnorm(at_home(p["q_norm"], row), h @ p["w_dq"].block(row.idx[0]))
        ckv_full = h @ p["w_dkv"].block(row.idx[0])
        c_kv = rmsnorm(at_home(p["kv_norm"], row), ckv_full[..., :m_.kv_lora])
        k_rope = apply_rope(ckv_full[..., None, m_.kv_lora:], positions, cfg.rope_theta)
    cqs, cks, krs, ps = (row.scatter(t) for t in (cq, c_kv, k_rope, positions))
    qp = col_project(row, cqs, p["w_uq"])
    kp = col_project(row, cks, p["w_uk"])
    vp = col_project(row, cks, p["w_uv"])
    outs = []
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        with row.at(m):
            q = take_cols(row, qp, m, h0 * qk, h1 * qk).reshape(b, n, h1 - h0, qk)
            q_rope = apply_rope(q[..., m_.nope_dim:], ps[m], cfg.rope_theta)
            k_nope = take_cols(row, kp, m, h0 * m_.nope_dim, h1 * m_.nope_dim)
            v = take_cols(row, vp, m, h0 * m_.v_dim, h1 * m_.v_dim)
            o = mla_core(cfg, layer, q[..., :m_.nope_dim], q_rope,
                         k_nope.reshape(b, n, h1 - h0, m_.nope_dim), krs[m],
                         v.reshape(b, n, h1 - h0, m_.v_dim))
        outs.append((m, h0 * m_.v_dim, o))
    return _vq_and_mix(p, cfg, row, outs, H * m_.v_dim, train, vq_noise)


def rwkv_rows(p: dict, cfg: ArchConfig, row: Row, h: torch.Tensor, x_prev: torch.Tensor,
              state=None) -> tuple[torch.Tensor, dict]:
    """``rwkv6.rwkv_time_mix`` (``state`` None: a sequence from a zero
    state, through the chunked scan) or ``rwkv_time_mix_step`` (``state(m,
    h0, h1)``: entry m's heads' WKV state on its device) on the row, the
    token-shifted stream ``x_prev`` at home. Returns (out at home, {model
    index: (first head, its heads' new state)})."""
    b, n, d = h.shape
    dh = cfg.rwkv.head_dim
    H = d // dh
    with row.at(0):
        mu = p["mu"].block(row.idx[0])
        xr, xk, xv, xw, xg = (h + (x_prev - h) * mu[i] for i in range(5))
        lora = torch.tanh(xw.to(torch.float32) @ p["w_dec_a"].block(row.idx[0]).to(torch.float32))
    rp = col_project(row, row.scatter(xr), p["w_r"])
    kp = col_project(row, row.scatter(xk), p["w_k"])
    vp = col_project(row, row.scatter(xv), p["w_v"])
    gp = []
    for m, lo, g in col_project(row, row.scatter(xg), p["w_g"]):
        with row.at(m):
            gp.append((m, lo, F.silu(g)))
    ls = row.scatter(lora)
    outs, states = [], {}
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        c0, c1, hm, e = h0 * dh, h1 * dh, h1 - h0, row.idx[m]
        with row.at(m):
            split = lambda a: a.reshape(b, n, hm, dh).movedim(2, 1)  # noqa: E731
            r, k, v = (split(take_cols(row, pc, m, c0, c1)) for pc in (rp, kp, vp))
            w_b = p["w_dec_b"].block(e)[:, c0:c1].to(torch.float32)
            logw = split(-torch.exp(p["w0"].block(e)[c0:c1] + ls[m] @ w_b))
            u = p["u"].block(e)[c0:c1].reshape(hm, dh)
            if state is None:
                pad = -n % CHUNK
                if pad:
                    r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
                y, s_new = lin_attn_chunked(r, k, v, logw, u=u, mamba_style=False)
                y = y[:, :, :n]
            else:
                y, s_new = lin_attn_decode_step(r[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                logw[:, :, 0], state(m, h0, h1), u=u)
                y = y[:, :, None]
            y = groupnorm(y.movedim(1, 2).reshape(b, n, hm * dh).to(h.dtype), hm,
                          p["gn_scale"].block(e)[c0:c1], p["gn_bias"].block(e)[c0:c1])
            outs.append((m, c0, y * take_cols(row, gp, m, c0, c1)))
        states[m] = (h0, s_new)
    return row_project_sum(row, outs, p["w_o"]), states


def channel_mix_rows(p: dict, row: Row, h: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """``rwkv6.rwkv_channel_mix`` on the row: ``relu²(xk·w_k)·w_v`` by
    ``w_k``'s columns and ``w_v``'s rows, summed at home; ``sigmoid(xr·
    w_r)`` by ``w_r``'s columns, gathered at home; their product there."""
    with row.at(0):
        mu = p["mu"].block(row.idx[0])
        xk = h + (x_prev - h) * mu[0]
        xr = h + (x_prev - h) * mu[1]
    hid, rs = [], []
    for m, lo, u in col_project(row, row.scatter(xk), p["w_k"]):
        with row.at(m):
            hid.append((m, lo, torch.square(F.relu(u))))
    kv = row_project_sum(row, hid, p["w_v"])
    for m, lo, r in col_project(row, row.scatter(xr), p["w_r"]):
        with row.at(m):
            rs.append((m, lo, torch.sigmoid(r)))
    with row.at(0):
        return take_cols(row, rs, 0, 0, h.shape[-1]) * kv


def conv_rows(p: dict, row: Row, xzp: list, conv_state=None) -> tuple[list, dict]:
    """hymba's causal conv (then SiLU) by ``conv_w``'s column blocks, each
    over the ``x`` columns of ``w_xz``'s pieces ``xzp`` gathered to the
    block's entry; ``conv_state(m, lo, hi)`` (decode) its block of the
    previous inputs. Returns ([(model index, first column, conv'd block)],
    {model index: (first column, new conv state block)})."""
    out, states = [], {}
    for m, lo, hi in owners(p["conv_w"], row, -1):
        e = row.idx[m]
        with row.at(m):
            xc, st = _causal_conv({"conv_w": p["conv_w"].block(e), "conv_b": p["conv_b"].block(e)},
                                  take_cols(row, xzp, m, lo, hi),
                                  None if conv_state is None else conv_state(m, lo, hi))
        out.append((m, lo, xc))
        states[m] = (lo, st)
    return out, states


def ssm_rows(p: dict, cfg: ArchConfig, row: Row, h: torch.Tensor, xzp: list, xcp: list,
             state=None) -> tuple[list, dict]:
    """hymba's SSM heads on the row: ``B``, ``C`` and the decay at home (their
    weights replicated), each entry's whole heads scanned over its ``xc``
    and ``z`` columns (``state`` None: the chunked scan from zero; else
    ``state(m, h0, h1)``, one decode step). Returns ([(model index, first
    column, the heads' gated output)], {model index: (first head, new
    state)})."""
    b, n, _ = h.shape
    H, dh, ds = cfg.n_heads, cfg.resolved_head_dim, cfg.ssm.d_state
    with row.at(0):
        e = row.idx[0]
        Bm, Cm = h @ p["w_B"].block(e), h @ p["w_C"].block(e)
        dt = F.softplus(h.to(torch.float32) @ p["w_dt"].block(e).to(torch.float32)
                        + p["dt_bias"].block(e))  # [b, n, H]
        logw = -(dt * torch.exp(p["A_log"].block(e)))
    sB, sC = row.scatter(Bm), row.scatter(Cm)
    outs, states = [], {}
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        hm = h1 - h0
        dt_m, lw_m = (move(t[..., h0:h1], row.idx[0], row.idx[m], row.grid, "model_bcast")
                      for t in (dt, logw))
        with row.at(m):
            xc = take_cols(row, xcp, m, h0 * dh, h1 * dh)
            z = take_cols(row, xzp, m, H * dh + h0 * dh, H * dh + h1 * dh)
            q = sC[m][:, None].expand(b, hm, n, ds)
            k = sB[m][:, None].expand(b, hm, n, ds) * dt_m.movedim(-1, 1)[..., None]
            v = xc.reshape(b, n, hm, dh).movedim(2, 1)
            lw = lw_m.movedim(-1, 1)[..., None].expand(b, hm, n, ds)
            if state is None:
                pad = -n % CHUNK
                if pad:
                    q, k, v, lw = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v, lw))
                y, s_new = lin_attn_chunked(q, k, v, lw, mamba_style=True)
                y = y[:, :, :n]
            else:
                y, s_new = lin_attn_decode_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], lw[:, :, 0],
                                                state(m, h0, h1), mamba_style=True)
                y = y[:, :, None]
            outs.append((m, h0 * dh, y.movedim(1, 2).reshape(b, n, hm * dh).to(h.dtype)
                         * F.silu(z)))
        states[m] = (h0, s_new)
    return outs, states


def hymba_fuse(p: dict, cfg: ArchConfig, row: Row, attn_outs: list, ssm_outs: list,
               train: bool, vq_noise) -> tuple:
    """The two branches' outputs gathered at home, each RMSNorm'd over its
    whole H·dh there, averaged; then the VQ at home and ``wo`` by rows."""
    width = cfg.n_heads * cfg.resolved_head_dim
    with row.at(0):
        a = rmsnorm(at_home(p["norm_attn"], row), take_cols(row, attn_outs, 0, 0, width))
        s = rmsnorm(at_home(p["norm_ssm"], row), take_cols(row, ssm_outs, 0, 0, width))
        fused = 0.5 * (a + s)
    return _vq_and_mix(p, cfg, row, [(0, 0, fused)], width, train, vq_noise)


def hymba_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
               positions: torch.Tensor, *, train: bool, vq_noise) -> tuple:
    """``hymba.hymba_apply`` on the row."""
    xs = row.scatter(h)
    attn = attn_heads(p, cfg, layer, row, xs, row.scatter(positions))
    xzp = col_project(row, xs, p["w_xz"])
    xcp, _ = conv_rows(p, row, xzp)
    ssm, _ = ssm_rows(p, cfg, row, h, xzp, xcp)
    return hymba_fuse(p, cfg, row, attn, ssm, train, vq_noise)


def layer_rows(lp: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, x: torch.Tensor,
               positions: torch.Tensor, noise: Optional[torch.Tensor], *,
               train: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``transformer._layer_fwd`` on the row: (x, the layer's aux)."""
    with row.at(0):
        h = apply_norm(cfg.norm, at_home(lp["norm1"], row), x)
    if layer.mixer == "rwkv6":
        with row.at(0):
            prev = _token_shift(h)
        mix = rwkv_rows(lp["mixer"], cfg, row, h, prev)[0]
        aux = torch.zeros((), device=row.home)
    else:
        mixer = {"mla": mla_rows, "hymba": hymba_rows}.get(layer.mixer, attn_rows)
        mix, aux = mixer(lp["mixer"], cfg, layer, row, h, positions, train=train,
                         vq_noise=noise)
    with row.at(0):
        x = x + mix
        h2 = apply_norm(cfg.norm, at_home(lp["norm2"], row), x)
    if layer.ffn == "rwkv_cm":
        with row.at(0):
            prev = _token_shift(h2)
        y = channel_mix_rows(lp["ffn"], row, h2, prev)
    elif layer.ffn == "moe":
        f = lp["ffn"]
        shared = (partial(ffn_rows, "swiglu", f["shared"], row) if "shared" in f else None)
        with row.at(0):
            y, auxes = moe.moe_ep_row(f, cfg, h2, row.r, row.grid, row.idx, shared=shared)
            aux = aux + torch.stack(auxes).mean()
    else:
        y = ffn_rows(layer.ffn, lp["ffn"], row, h2)
    with row.at(0):
        return x + y, aux


def head_rows(P: dict, cfg: ArchConfig, row: Row, x: torch.Tensor) -> list:
    """``transformer._head`` on the row, before any gather: [(model index,
    first vocab column, logits block)], blocks of the vocab (of the
    flattened cb·V columns for an untied audio head)."""
    with row.at(0):
        xs = row.scatter(apply_norm(cfg.norm, at_home(P["final_norm"], row), x))
    if not cfg.tie_embeddings:
        return col_project(row, xs, P["lm_head"])
    tok = P["embed"]["tok"]
    audio = cfg.n_codebooks > 1
    pieces = []
    for m, lo, _ in owners(tok, row, 1 if audio else 0):
        with row.at(m):
            w = tok.block(row.idx[m])
            pieces.append((m, lo, torch.einsum("bnd,cvd->bncv", xs[m], w) if audio
                           else xs[m] @ w.T))
    return pieces


def gather_logits(row: Row, cfg: ArchConfig, pieces: list) -> torch.Tensor:
    """The row's whole logits at home, in ``_head``'s layout."""
    width = max(lo + t.shape[-1] for _, lo, t in pieces)
    logits = take_cols(row, pieces, 0, 0, width)
    if cfg.n_codebooks > 1 and not cfg.tie_embeddings:
        return logits.reshape(*logits.shape[:2], cfg.n_codebooks, cfg.vocab)
    return logits


def row_nll(row: Row, cfg: ArchConfig, pieces: list, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] a position, [b, n'] at home (audio:
    averaged over the codebooks, from gathered logits): a vocab-parallel
    cross-entropy over the pieces' vocab blocks."""
    if cfg.n_codebooks > 1:
        with row.at(0):
            logp = torch.log_softmax(gather_logits(row, cfg, pieces).to(torch.float32), -1)
            return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean(-1)
    maxes = []
    for m, _, t in pieces:
        with row.at(m):
            maxes.append((m, t.detach().to(torch.float32).amax(-1)))
    with row.at(0):
        gmax = torch.stack([move(t, row.idx[m], row.idx[0], row.grid, "model_sum")
                            for m, t in maxes]).amax(0)
    gs, ts = row.scatter(gmax), row.scatter(targets)
    sums, tgts = [], []
    for m, lo, t in pieces:
        with row.at(m):
            t = t.to(torch.float32)
            sums.append((m, torch.exp(t - gs[m][..., None]).sum(-1)))
            local = ts[m].long() - lo
            ok = (local >= 0) & (local < t.shape[-1])
            hit = torch.gather(t, -1, local.clamp(0, t.shape[-1] - 1)[..., None])[..., 0]
            tgts.append((m, torch.where(ok, hit, 0.0)))
    with row.at(0):
        return torch.log(row.sum_model(sums)) + gmax - row.sum_model(tgts)


# ---------------------------------------------------------------- the stack


class _Recomputed(Exception):
    """Stops a recompute once it has saved what the backward needs."""


def recomputed(fn, *args):
    """``fn(*args)`` with what its backward needs dropped and recomputed
    (``torch.utils.checkpoint``'s non-reentrant scheme, as ``forward``'s
    ``remat``), safe when the body spans several cards: autograd runs each
    card's part of the backward in that card's thread, and two threads may
    ask for the body's tensors at once, so the one recompute runs under a
    lock. The saved tensors are numbered as the forward packs them, the
    recompute packs them again in the same order (stopping at the last
    one, as the checkpoint's early stop), and each is released when the
    backward takes it."""
    lock, count, saved = threading.Lock(), [0], []

    def pack(_t):
        count[0] += 1
        return count[0] - 1

    def repack(t):
        saved.append(t)
        if len(saved) == count[0]:  # the rest of the body saves nothing the backward needs
            raise _Recomputed

    def unpack(i):
        with lock:
            if not saved:
                again = [a.detach().requires_grad_(a.requires_grad)
                         if isinstance(a, torch.Tensor) else a for a in args]
                try:
                    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                            repack, lambda _: None):
                        fn(*again)
                except _Recomputed:
                    pass
                if len(saved) != count[0]:
                    raise RuntimeError(f"recompute saved {len(saved)} tensors, "
                                       f"the forward {count[0]}")
            t, saved[i] = saved[i], None
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        return fn(*args)


def absent_rows(rows: list, nbytes: int, kind: str) -> None:
    """Under ``first_row_only``: count the ``nbytes`` each row that did not
    run would send the first row's home in a combine over the rows."""
    if getattr(_only, "on", False):
        grid = rows[0].grid
        every = grid_index_rows(grid)
        for row in every[len(rows):]:
            count_bytes(kind, nbytes, row[0], every[0][0], grid)


def row_inputs(t, rows: list, b_loc: int):
    """A batch leaf's rows (``b_loc`` each) on each row's home: a placed
    leaf's home blocks, or slices of a whole tensor (None stays None)."""
    if t is None:
        return [None] * len(rows)
    if isinstance(t, Blocks):
        return [t.block(row.idx[0]) for row in rows]
    t = torch.as_tensor(t)
    return [t[row.r * b_loc:(row.r + 1) * b_loc].to(row.home) for row in rows]


def _noise(cfg: ArchConfig, layer: LayerCfg, shape: tuple, li: int, gen, vq_noise,
           rows: list) -> list:
    """Layer ``li``'s Gumbel noise for the global batch (``vq_noise[li]``,
    else drawn from ``gen`` as ``transformer._layer_noise`` draws it), each
    row's slice on its home; None without VQ (or for an rwkv6 layer)."""
    if cfg.vqt is None or layer.mixer == "rwkv6":
        return [None] * len(rows)
    if vq_noise is not None:
        g = torch.as_tensor(vq_noise[li], dtype=torch.float32)
    else:
        g = vq_mod.gumbel(gen, (*shape, cfg.vqt.n_heads, cfg.vqt.codebook_size))
    b_loc = shape[0] // len(grid_index_rows(rows[0].grid))
    return [g[row.r * b_loc:(row.r + 1) * b_loc].to(row.home) for row in rows]


def run_rows(params: dict, cfg: ArchConfig, tokens, positions=None, *, patch_embeds=None,
             train: bool = False, rng: Optional[torch.Generator] = None, vq_noise=None,
             remat: bool = True, grid=None):
    """The stack under the active grid (or ``grid``). Returns (rows, the
    laid-out parameters, each row's final hidden state, tokens and
    positions, the mean of the rows' aux)."""
    from repro_torch.launch.sharding import place
    from repro_torch.models.embedding import merge_vision
    from repro_torch.models.transformer import _index

    grid = grid or active_grid()
    P = place(params, grid, copy=False)
    rows = rows_of(grid)
    shape = tuple(tokens.shape[:2])
    b, n = shape
    if b % len(rows):
        raise ValueError(f"batch {b} does not split over the {len(rows)} data rows of {grid}")
    b_loc = b // len(rows)
    if getattr(_only, "on", False):
        rows = rows[:1]
    toks = row_inputs(tokens, rows, b_loc)
    if positions is None:
        positions = torch.arange(n, dtype=torch.int32).expand(b, n)
    pos = row_inputs(positions, rows, b_loc)
    xs = [embed_rows(P["embed"], cfg, row, t, p) for row, t, p in zip(rows, toks, pos)]
    if cfg.input_mode == "vlm":
        if patch_embeds is None:
            raise ValueError("vlm input requires patch_embeds")
        pe = row_inputs(patch_embeds, rows, b_loc)
        npat = patch_embeds.shape[1]
        for r, row in enumerate(rows):
            with row.at(0):
                xs[r] = merge_vision(at_home({"vis_proj": P["embed"]["vis_proj"]}, row),
                                     pe[r], xs[r])
                bl = pos[r].shape[0]
                pos[r] = torch.cat([torch.arange(npat, dtype=pos[r].dtype,
                                                 device=row.home).expand(bl, npat),
                                    pos[r] + npat], dim=1)
        shape = (b, n + npat)
    auxes = [torch.zeros((), device=row.home) for row in rows]
    if train and rng is None and rows[0].home.type != "meta":
        rng = torch.Generator(device=rows[0].home).manual_seed(0)
    ctx = get_ctx()
    li = 0
    for (pattern, repeat), sp in zip(cfg.stages, P["stages"]):
        for r_ in range(repeat):
            spr = _index(sp, r_)
            for layer, lp in zip(pattern, spr):
                noise = (_noise(cfg, layer, shape, li, rng, vq_noise, rows) if train
                         else [None] * len(rows))
                for r, row in enumerate(rows):
                    body = with_ctx(ctx, partial(layer_rows, lp, cfg, layer, row, train=train))
                    xs[r], a = (recomputed(body, xs[r], pos[r], noise[r]) if train and remat
                                else body(xs[r], pos[r], noise[r]))
                    with row.at(0):
                        auxes[r] = auxes[r] + a
                li += 1
    first = rows[0]
    absent_rows(rows, auxes[0].numel() * auxes[0].element_size(), "data_sum")
    aux = sum_to([(row.idx[0], a) for row, a in zip(rows, auxes)], first.idx[0], grid,
                 "data_sum") / len(rows)
    return rows, P, xs, toks, pos, aux


def mtp_rows(P: dict, cfg: ArchConfig, row: Row, x: torch.Tensor, tokens: torch.Tensor,
             positions: torch.Tensor) -> list:
    """DeepSeek-V3's MTP head on the row (``transformer.forward``'s): its
    logits pieces."""
    n = tokens.shape[1]
    mp = P["mtp"]
    emb = torch.roll(embed_rows(P["embed"], cfg, row, tokens, positions[:, -n:]), -1, dims=1)
    with row.at(0):
        hcat = torch.cat([apply_norm(cfg.norm, at_home(mp["norm_h"], row), x[:, -n:]),
                          apply_norm(cfg.norm, at_home(mp["norm_e"], row), emb.to(x.dtype))],
                         dim=-1)
        h = hcat @ mp["proj"].block(row.idx[0])
        hn = apply_norm(cfg.norm, at_home(mp["norm_f"], row), h)
    h = h + ffn_rows("swiglu", mp["ffn"], row, hn)
    return head_rows(P, cfg, row, h)


def forward(params: dict, cfg: ArchConfig, tokens, positions=None, *, patch_embeds=None,
            train: bool = False, rng: Optional[torch.Generator] = None, vq_noise=None,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """``transformer.forward`` under the active grid: the same (logits,
    {"aux_loss", "hidden"[, "mtp_logits"]}), gathered on the grid's first
    device."""
    rows, P, xs, toks, pos, aux = run_rows(params, cfg, tokens, positions,
                                           patch_embeds=patch_embeds, train=train, rng=rng,
                                           vq_noise=vq_noise, remat=remat)
    first = rows[0]
    gather = lambda ts: torch.cat([  # noqa: E731
        move(t, row.idx[0], first.idx[0], first.grid, "data_gather") for row, t in zip(rows, ts)])
    logits = [gather_logits(row, cfg, head_rows(P, cfg, row, x)) for row, x in zip(rows, xs)]
    out = {"aux_loss": aux, "hidden": gather(xs)}
    if cfg.mtp and "mtp" in P:
        out["mtp_logits"] = gather([gather_logits(row, cfg, mtp_rows(P, cfg, row, x, t, p))
                                    for row, x, t, p in zip(rows, xs, toks, pos)])
    return gather(logits), out


def lm_loss(params, cfg: ArchConfig, batch: dict, rng: Optional[torch.Generator], *,
            aux_weight: float = 1.0, vq_noise=None):
    """``training.step.lm_loss`` under the active grid: each row's
    vocab-parallel next-token sums and counts added over the data rows, so
    the loss is the global mean weighted by each row's kept targets."""
    rows, P, xs, toks, pos, aux = run_rows(params, cfg, batch["tokens"], batch.get("positions"),
                                           patch_embeds=batch.get("patch_embeds"), train=True,
                                           rng=rng, vq_noise=vq_noise)
    b = batch["tokens"].shape[0]
    masks = row_inputs(batch.get("mask"), rows, b // len(rows_of(rows[0].grid)))
    first = rows[0]

    def mean_nll(pieces_of, cut: int) -> torch.Tensor:
        """The mean next-token nll of the pieces' logits [:, :-1 - cut]
        against the tokens [:, 1 + cut:] (``cut`` 1: the MTP head's t + 2)."""
        sums, counts = [], []
        for row, x, t, p, mask in zip(rows, xs, toks, pos, masks):
            n_text = t.shape[1]
            pieces = [(m, lo, l[:, -n_text:][:, :-1 - cut]) for m, lo, l in pieces_of(row, x, t, p)]
            nll = row_nll(row, cfg, pieces, t[:, 1 + cut:])
            with row.at(0):
                if mask is not None and not cut:
                    mk = mask[:, 1:].to(torch.float32)
                    sums.append((row.idx[0], torch.sum(nll * mk)))
                    counts.append((row.idx[0], torch.sum(mk)))
                else:
                    sums.append((row.idx[0], torch.sum(nll)))
        absent_rows(rows, 4 * (1 + bool(counts)), "data_sum")
        total = sum_to(sums, first.idx[0], first.grid, "data_sum")
        if counts:
            return total / torch.clamp(sum_to(counts, first.idx[0], first.grid, "data_sum"),
                                       min=1.0)
        return total / (b * (toks[0].shape[1] - 1 - cut))

    lm = mean_nll(lambda row, x, t, p: head_rows(P, cfg, row, x), 0)
    loss = lm + aux_weight * aux
    if cfg.mtp and "mtp" in P:
        loss = loss + 0.3 * mean_nll(lambda row, x, t, p: mtp_rows(P, cfg, row, x, t, p), 1)
    return loss, {"lm_loss": lm, "aux_loss": aux}
