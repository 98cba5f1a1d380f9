"""One decode step across a grid — ``transformer.decode_step`` (and so
``serving.decode.make_serve_step``) run by the caches' plan
(``launch.sharding.cache_shardings``, laid out by ``place_caches``), the
counterpart of the reference's jitted serve step under ``in_shardings``
(``repro/launch/dryrun.py:131-152``).

Two layouts, as the plan chooses by the batch (``decode_splits_batch``):

* **batch split**: each data row decodes its rows of the batch as the
  forward does (``models.sharded``): heads, FFN hidden and vocab over the
  model axis, each entry's whole heads against its block of the caches;
* **sequence split** (a batch smaller than the data axes: ``long_500k``'s
  batch 1): the attention caches' sequence axis is cut over "data". The
  first data row runs the layer; each row that holds a slice of the
  sequence (the first row of each "data" index) computes its entries'
  heads' partial attention over its slice — the query sent there
  ("seq_bcast"), the partials sent back ("seq_combine": softmax's (max,
  Σexp, Σexp·v) with the log-sum-exp shift, σ's Σ gelu(s)·v and the valid
  keys' count) and combined at the first row.

The new token's k / v (MLA: c_kv / k_rope) are computed once for each
distinct block of heads (rotated on the first entry that holds it) and
copied to every holder ("cache_copy"), written at slot ``min(len, S -
1)`` (a ring: ``len % S``) by the rows whose slice holds it; under a
sequence split the slots are read on the host once a step (meta tensors:
each cache taken as full, the slot its last). Recurrent states (rwkv6's
``S`` and token-shift carries, hymba's SSM and conv states) are computed
on the entries that own their heads or columns and copied to every other
holder, so every replica of a cache leaf stays bitwise equal; ``len``
adds one at every holder (exact). Every layer runs under ``at_entry``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.distributed.context import (
    Blocks, NamedSharding, PartitionSpec, active_grid, move,
)
from repro_torch.models import moe
from repro_torch.models.attention import _write_rows, apply_rope
from repro_torch.models.norms import apply_norm, rmsnorm
from repro_torch.models.sharded import (
    Row, _only, _vq_and_mix, absent_rows, at_home, channel_mix_rows, col_project, conv_rows, embed_rows,
    ffn_rows, gather_logits, gather_range, head_rows, heads_of, hymba_fuse, owners,
    row_inputs, rows_of, rwkv_rows, ssm_rows, take_cols,
)


@dataclass
class Step:
    """One decode step's layout: the rows that run layers (``run``), the
    rows holding each sequence slice (``seq``; with the batch split, each
    running row its own), and the new cache tensors by the id of the old
    ones they replace."""
    grid: object
    split_batch: bool
    run: list
    seq: list
    new: dict = field(default_factory=dict)

    def entries(self, row: Row) -> set:
        """The grid entries whose cache blocks ``row`` renews."""
        return set(row.idx) if self.split_batch else set(np.ndindex(self.grid.devices.shape))

    def seq_rows(self, row: Row) -> list:
        return [row] if self.split_batch else self.seq

    def now(self, leaf: Blocks, idx) -> torch.Tensor:
        """``leaf``'s block at ``idx`` as renewed so far this step."""
        t = leaf.block(idx)
        return self.new.get(id(t), t)


def model_index(grid, idx) -> int:
    names = grid.axis_names
    return idx[names.index("model")] if "model" in names else 0


def holders(leaf: Blocks, entries: set) -> list:
    """[(first holder's grid index, its block's slices, tensor)] of each
    distinct tensor of ``leaf`` whose first holder is in ``entries``."""
    blocks = leaf.sharding.blocks(leaf.shape)
    seen, out = set(), []
    for idx, t in leaf.tensors.items():
        if id(t) not in seen:
            seen.add(id(t))
            if idx in entries:
                out.append((idx, blocks[idx], t))
    return out


def renewed(leaf: Blocks, st: Step) -> Blocks:
    return leaf.with_tensors([st.new.get(id(t), t) for t in leaf.distinct()])


def refill(leaf: Blocks, pieces: list, dim: int, st: Step, row: Row) -> None:
    """Every block of ``leaf`` that ``row`` renews: its range along ``dim``
    of the tensor ``pieces`` ([(grid index, first index, piece)]) partition,
    moved from the pieces' entries ("cache_copy")."""
    src = {id(t): i for i, _, t in pieces}
    for idx, sl, t in holders(leaf, st.entries(row)):
        s = sl[dim]
        new = gather_range(st.grid, pieces, idx, s.start, s.stop, "cache_copy", dim)
        if src.get(id(new), idx) != idx:  # another entry's piece, on a shared device
            new = new.clone()
        st.new[id(t)] = new.to(t.dtype)


def bump(leaf: Blocks, st: Step, row: Row) -> None:
    """``len`` + 1 at every holder ``row`` renews."""
    for _, _, t in holders(leaf, st.entries(row)):
        st.new[id(t)] = t + 1


def _slot(lens: torch.Tensor, S: int, window) -> torch.Tensor:
    return lens % S if window is not None else torch.clamp(lens, max=S - 1)


def write_token(leaf: Blocks, lens: Blocks, new_of, window, st: Step, row: Row,
                host_slots) -> None:
    """The new token's rows into every block of the [b, S, ...] cache
    ``leaf`` that ``row`` renews and whose sequence slice holds a slot:
    ``new_of(idx, slices)`` gives the token's [b_blk, 1, ...] block on
    entry ``idx``; the slot is each row's ``len`` there (``host_slots``:
    the slots on the host, under a sequence split)."""
    S = leaf.shape[1]
    for idx, sl, t in holders(leaf, st.entries(row)):
        s0, s1 = sl[1].start, sl[1].stop
        if host_slots is not None and not any(s0 <= int(v) < s1 for v in host_slots):
            continue
        slot = _slot(lens.block(idx).long(), S, window)
        new = new_of(idx, sl).to(t.dtype)
        if (s0, s1) == (0, S):
            st.new[id(t)] = _write_rows(t, new, slot)
            continue
        local = slot - s0
        ok = (local >= 0) & (local < s1 - s0)
        at = local.clamp(0, s1 - s0 - 1)
        out = t.clone()
        ar = torch.arange(t.shape[0], device=t.device)
        keep = out[ar, at]
        out[ar, at] = torch.where(ok.view(-1, *([1] * (keep.dim() - 1))), new[:, 0], keep)
        st.new[id(t)] = out


def partials(scores: torch.Tensor, valid: torch.Tensor, softmax: bool):
    """Unnormalised weights of f32 ``scores`` [b, h, 1, k] over ``valid``
    [b, k] keys and their (denominator, max) [b, h, 1, 1]: softmax's
    exp(s − max) and Σ, σ's gelu(s) and the valid count (max None)."""
    mask = valid[:, None, None, :]
    if softmax:
        s = torch.where(mask, scores, torch.full_like(scores, -1e30))
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - mx) * mask
        return e, e.sum(-1, keepdim=True), mx
    w = F.gelu(scores, approximate="tanh") * mask
    return w, mask.sum(-1, keepdim=True).to(torch.float32), None


def combine(parts: list, softmax: bool) -> torch.Tensor:
    """[(numerator, denominator, max)] of the sequence slices, on one
    device, combined as one attention over all the keys."""
    if softmax:
        top = torch.stack([mx for _, _, mx in parts]).amax(0)
        num = den = None
        for n_, d_, mx in parts:
            f = torch.exp(mx - top)
            num = n_ * f if num is None else num + n_ * f
            den = d_ * f if den is None else den + d_ * f
        return num / den
    num = den = None
    for n_, d_, _ in parts:
        num = n_ if num is None else num + n_
        den = d_ if den is None else den + d_
    return num / torch.clamp(den, min=1.0)


def seq_attend(st: Step, row: Row, m: int, q: torch.Tensor, leaf: Blocks, lens: Blocks,
               softmax: bool, scores_of, values_of) -> torch.Tensor:
    """Entry m's heads' attention over the cache ``leaf``'s sequence
    slices: ``q`` sent to each slice's holder ("seq_bcast"),
    ``scores_of(q, idx)`` [b, h, 1, k] and ``values_of(w, idx)`` computed
    there over its renewed blocks, the partials sent back ("seq_combine")
    and combined on row's entry m."""
    S = leaf.shape[1]
    home = row.idx[m]
    blocks = leaf.sharding.blocks(leaf.shape)
    parts = []
    for sr in st.seq_rows(row):
        idx = sr.idx[m]
        s0, s1 = blocks[idx][1].start, blocks[idx][1].stop
        with sr.at(m):
            qq = move(q, home, idx, st.grid, "seq_bcast")
            ln = lens.block(idx).long()
            keys = torch.arange(s0, s1, device=qq.device)[None, :]
            valid = keys < torch.clamp(ln + 1, max=S)[:, None]
            w, den, mx = partials(scores_of(qq, idx), valid, softmax)
            num = values_of(w, idx)
        parts.append(tuple(None if t is None else move(t, idx, home, st.grid, "seq_combine")
                           for t in (num, den, mx)))
    with row.at(m):
        return combine(parts, softmax)


# ---------------------------------------------------------------- mixers


def attn_decode_heads(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, xs, ps,
                      cache: dict, st: Step, host_slots) -> list:
    """GQA's decode on the row: the new k / v into their caches, each
    entry's whole heads over the slices. [(model index, first column,
    [b, 1, heads·dh])]."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rep = H // Hkv
    b = xs.t.shape[0]
    qp = col_project(row, xs, p["wq"], p.get("bq"))
    kp = col_project(row, xs, p["wk"], p.get("bk"))
    vp = col_project(row, xs, p["wv"], p.get("bv"))
    kc, vc, lc = cache["k"], cache["v"], cache["len"]
    rope = cfg.pos == "rope"
    for leaf, pieces, rot in ((kc, kp, rope), (vc, vp, False)):
        made: dict = {}
        g_pieces = [(row.idx[j], lo, t) for j, lo, t in pieces]

        def new_of(idx, sl, pieces=g_pieces, rot=rot, made=made):
            k0, k1 = sl[2].start, sl[2].stop
            if (k0, k1) not in made:  # computed on the row's entry of the same model index
                m = model_index(st.grid, idx)
                with row.at(m):
                    t = gather_range(st.grid, pieces, row.idx[m], k0 * dh, k1 * dh,
                                     "model_gather").reshape(b, 1, k1 - k0, dh)
                    made[(k0, k1)] = (row.idx[m], apply_rope(t, ps[m], cfg.rope_theta)
                                      if rot else t)
            src, t = made[(k0, k1)]
            return move(t, src, idx, st.grid, "cache_copy")

        write_token(leaf, lc, new_of, layer.window, st, row, host_slots)
    bump(lc, st, row)
    kblocks = kc.sharding.blocks(kc.shape)
    outs = []
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        with row.at(m):
            q = take_cols(row, qp, m, h0 * dh, h1 * dh).reshape(b, 1, h1 - h0, dh)
            if rope:
                q = apply_rope(q, ps[m], cfg.rope_theta)

        def sel(idx, h0=h0, h1=h1):
            k0 = kblocks[idx][2].start
            return torch.tensor([hh // rep - k0 for hh in range(h0, h1)],
                                device=torch.device(st.grid.devices[idx]))

        def scores_of(qq, idx, sel=sel):
            k = st.now(kc, idx).index_select(2, sel(idx))
            return torch.einsum("bqhd,bkhd->bhqk", qq.to(torch.float32),
                                k.to(torch.float32)) * dh ** -0.5

        def values_of(w, idx, sel=sel):
            v = st.now(vc, idx).index_select(2, sel(idx))
            return torch.einsum("bhqk,bkhd->bhqd", w, v.to(torch.float32))

        o = seq_attend(st, row, m, q, kc, lc, cfg.attn_softmax, scores_of, values_of)
        with row.at(m):
            outs.append((m, h0 * dh, o.movedim(1, 2).reshape(b, 1, (h1 - h0) * dh)))
    return outs


def weight_cols(row: Row, w: Blocks, m: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of a column-split weight on entry m (its own block
    where they lie in it)."""
    pieces = [(row.idx[j], a, w.block(row.idx[j])) for j, a, _ in owners(w, row, -1)]
    return gather_range(row.grid, pieces, row.idx[m], lo, hi, "model_gather")


def mla_decode_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
                    positions: torch.Tensor, cache: dict, st: Step, host_slots) -> torch.Tensor:
    """``mla.mla_decode`` (the absorbed form) on the row: the latents at
    home and copied into every holder of the caches; each entry's whole
    heads absorb ``w_uk`` / ``w_uv`` by their columns."""
    m_ = cfg.mla
    b = h.shape[0]
    H = cfg.n_heads
    qk = m_.nope_dim + m_.rope_dim
    with row.at(0):
        e = row.idx[0]
        cq = rmsnorm(at_home(p["q_norm"], row), h @ p["w_dq"].block(e))
        full = h @ p["w_dkv"].block(e)
        c_new = rmsnorm(at_home(p["kv_norm"], row), full[..., :m_.kv_lora])
        kr_new = apply_rope(full[..., None, m_.kv_lora:], positions, cfg.rope_theta)[:, :, 0]
    lc = cache["len"]
    for leaf, t in ((cache["ckv"], c_new), (cache["krope"], kr_new)):
        write_token(leaf, lc, lambda idx, sl, t=t: move(t, row.idx[0], idx, st.grid,
                                                        "cache_copy"),
                    None, st, row, host_slots)
    bump(lc, st, row)
    qp = col_project(row, row.scatter(cq), p["w_uq"])
    ps = row.scatter(positions)
    scale = qk ** -0.5
    outs = []
    for m in range(row.M):
        h0, h1 = heads_of(row, m, H)
        if h0 == h1:
            continue
        hm = h1 - h0
        with row.at(m):
            q = take_cols(row, qp, m, h0 * qk, h1 * qk).reshape(b, 1, hm, qk)
            q_rope = apply_rope(q[..., m_.nope_dim:], ps[m], cfg.rope_theta)
            w_uk = weight_cols(row, p["w_uk"], m, h0 * m_.nope_dim, h1 * m_.nope_dim)
            q_lat = torch.einsum("bqhd,chd->bqhc", q[..., :m_.nope_dim],
                                 w_uk.reshape(m_.kv_lora, hm, m_.nope_dim))
            qcat = torch.cat([q_lat, q_rope], dim=-1)

        def scores_of(qq, idx):
            ckv, kr = st.now(cache["ckv"], idx), st.now(cache["krope"], idx)
            s = torch.einsum("bqhc,bkc->bhqk", qq[..., :m_.kv_lora].to(torch.float32),
                             ckv.to(torch.float32))
            s = s + torch.einsum("bqhd,bkd->bhqk", qq[..., m_.kv_lora:].to(torch.float32),
                                 kr.to(torch.float32))
            return s * scale

        def values_of(w, idx):
            return torch.einsum("bhqk,bkc->bhqc", w, st.now(cache["ckv"], idx).to(torch.float32))

        o_lat = seq_attend(st, row, m, qcat, cache["ckv"], lc, cfg.attn_softmax, scores_of,
                           values_of)  # [b, hm, 1, kv_lora]
        with row.at(m):
            w_uv = weight_cols(row, p["w_uv"], m, h0 * m_.v_dim, h1 * m_.v_dim)
            o = torch.einsum("bhqc,chd->bqhd", o_lat, w_uv.reshape(m_.kv_lora, hm, m_.v_dim))
            outs.append((m, h0 * m_.v_dim, o.reshape(b, 1, hm * m_.v_dim)))
    return _vq_and_mix(p, cfg, row, outs, H * m_.v_dim, False, None)[0]


def _state_of(leaf: Blocks, row: Row, dim: int):
    """``state(m, lo, hi)``: [lo, hi) along ``dim`` of ``leaf``'s block on
    row's entry m (which holds that range: its heads or columns)."""
    blocks = leaf.sharding.blocks(leaf.shape)

    def get(m, lo, hi):
        idx = row.idx[m]
        s = blocks[idx][dim]
        return leaf.block(idx).narrow(dim, lo - s.start, hi - lo)

    return get


def hymba_decode_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
                      positions: torch.Tensor, cache: dict, st: Step, host_slots
                      ) -> torch.Tensor:
    """``hymba.hymba_decode`` on the row: the attention branch as GQA's,
    the conv states by ``conv_w``'s column blocks, the SSM states by each
    entry's whole heads, each copied to their other holders."""
    xs = row.scatter(h)
    attn = attn_decode_heads(p, cfg, layer, row, xs, row.scatter(positions), cache["attn"], st,
                             host_slots)
    xzp = col_project(row, xs, p["w_xz"])
    xcp, convs = conv_rows(p, row, xzp, _state_of(cache["conv_state"], row, -1))
    ssm, states = ssm_rows(p, cfg, row, h, xzp, xcp, _state_of(cache["ssm_state"], row, 1))
    refill(cache["conv_state"], [(row.idx[m], lo, t) for m, (lo, t) in convs.items()], -1,
           st, row)
    refill(cache["ssm_state"], [(row.idx[m], h0, t) for m, (h0, t) in states.items()], 1,
           st, row)
    return hymba_fuse(p, cfg, row, attn, ssm, False, None)[0]


def layer_decode_rows(lp: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict, st: Step, host_slots
                      ) -> torch.Tensor:
    """``transformer._layer_decode`` on the row; the cache's new blocks go
    to ``st.new``."""
    with row.at(0):
        h = apply_norm(cfg.norm, at_home(lp["norm1"], row), x)
    p = lp["mixer"]
    if layer.mixer == "rwkv6":
        tm = cache["tm"]
        with row.at(0):
            prev = tm["x_last"].block(row.idx[0])[:, None, :].to(h.dtype)
        mix, states = rwkv_rows(p, cfg, row, h, prev, _state_of(tm["S"], row, 1))
        refill(tm["S"], [(row.idx[m], h0, t) for m, (h0, t) in states.items()], 1, st, row)
        refill(tm["x_last"], [(row.idx[0], 0, h[:, -1])], -1, st, row)
    elif layer.mixer == "mla":
        mix = mla_decode_rows(p, cfg, layer, row, h, positions, cache, st, host_slots)
    elif layer.mixer == "hymba":
        mix = hymba_decode_rows(p, cfg, layer, row, h, positions, cache, st, host_slots)
    else:
        outs = attn_decode_heads(p, cfg, layer, row, row.scatter(h), row.scatter(positions),
                                 cache, st, host_slots)
        mix = _vq_and_mix(p, cfg, row, outs, cfg.n_heads * cfg.resolved_head_dim, False,
                          None)[0]
    with row.at(0):
        x = x + mix
        h2 = apply_norm(cfg.norm, at_home(lp["norm2"], row), x)
    f = lp["ffn"]
    if layer.ffn == "rwkv_cm":
        with row.at(0):
            prev = cache["cm_x_last"].block(row.idx[0])[:, None, :].to(h2.dtype)
        y = channel_mix_rows(f, row, h2, prev)
        refill(cache["cm_x_last"], [(row.idx[0], 0, h2[:, -1])], -1, st, row)
    elif layer.ffn == "moe":
        shared = (lambda z: ffn_rows("swiglu", f["shared"], row, z)) if "shared" in f else None
        with row.at(0):
            y, _ = moe.moe_ep_row(f, cfg, h2, row.r, row.grid, row.idx, shared=shared)
    else:
        y = ffn_rows(layer.ffn, f, row, h2)
    with row.at(0):
        return x + y


# ---------------------------------------------------------------- the step


def _renew_tree(tree, st: Step):
    if isinstance(tree, dict):
        return {k: _renew_tree(v, st) for k, v in tree.items()}
    return renewed(tree, st)


def stack_blocks(leaves: list) -> Blocks:
    """Same-layout ``Blocks`` stacked along a new leading (repeat) axis,
    sharing tensors where every layer shares them."""
    first = leaves[0]
    memo, tensors = {}, {}
    for idx in first.tensors:
        key = tuple(id(leaf.tensors[idx]) for leaf in leaves)
        if key not in memo:
            memo[key] = torch.stack([leaf.tensors[idx] for leaf in leaves])
        tensors[idx] = memo[key]
    spec = PartitionSpec(None, *first.sharding.spec)
    return Blocks(NamedSharding(first.grid, spec), (len(leaves),) + first.shape, tensors)


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return stack_blocks(trees)


def _attn_cache(cache: dict) -> Optional[dict]:
    """A layer cache's attention part ({"k" | "ckv", ..., "len"}), None for
    rwkv6's."""
    return cache["attn"] if "attn" in cache else cache if "len" in cache else None


def host_lens(caches: list) -> list:
    """Each stage's pattern's attention ``len`` [r, b] on the host (None
    for an rwkv6 layer), read in one copy; on ``meta`` each is None (the
    cache taken as full)."""
    found = [c["len"].tensors[next(iter(c["len"].tensors))]
             for sc in caches for c in (_attn_cache(x["mix"]) for x in sc) if c is not None]
    host = iter([None] * len(found))
    if found and found[0].device.type != "meta":
        flat = torch.cat([t.reshape(-1).to(found[0].device) for t in found]).cpu().numpy()
        cuts = np.cumsum([t.numel() for t in found])[:-1]
        host = iter(a.reshape(t.shape) for a, t in zip(np.split(flat, cuts), found))
    return [[None if _attn_cache(x["mix"]) is None else next(host) for x in sc]
            for sc in caches]


def host_slots(cache: dict, lens, r: int, window) -> Optional[list]:
    """The slots a layer's new token goes to, on the host (``lens`` its
    stage's [r, b] lengths; None: the cache full, its last slot)."""
    c = _attn_cache(cache)
    if c is None:
        return None
    S = (c["k"] if "k" in c else c["ckv"]).shape[1]
    if lens is None:
        return [S - 1]
    return [int(v) for v in _slot(torch.as_tensor(lens[r]).long(), S, window)]


def decode_step(params: dict, cfg: ArchConfig, tokens, caches: list, positions
                ) -> tuple[torch.Tensor, list]:
    """``transformer.decode_step`` under the active grid: (logits [b, 1,
    ...] on the grid's first device, the new caches laid out by their
    plan). Whole caches are placed first (``place_caches``), and whole
    parameters are laid out for this call (``place`` without copies where
    the entry is the leaf's own device): a loop of steps places them once
    before it, as ``greedy_decode`` does."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch.sharding import decode_splits_batch, place, place_caches
    from repro_torch.models.transformer import _index

    grid = active_grid()
    b = tokens.shape[0]
    P = place(params, grid, copy=False)
    if not all(isinstance(leaf, Blocks) for leaf in tree_leaves(caches)):
        caches = place_caches(caches, grid, batch=b)
    rows = rows_of(grid)
    split = decode_splits_batch(grid, b)
    if split:
        run = rows[:1] if getattr(_only, "on", False) else rows
        seq = run
    else:
        run = rows[:1]
        names = grid.axis_names
        seq, seen = [], set()
        for row in rows:  # the first row of each "data" index holds its slice
            d = row.idx[0][names.index("data")] if "data" in names else 0
            if d not in seen:
                seen.add(d)
                seq.append(row)
    st = Step(grid, split, run, seq)
    b_loc = b // len(rows) if split else b
    toks = row_inputs(tokens, run, b_loc)
    pos = row_inputs(positions, run, b_loc)
    xs = [embed_rows(P["embed"], cfg, row, t, q) for row, t, q in zip(run, toks, pos)]
    lens = host_lens(caches) if not split else None
    new_caches = []
    for si, ((pattern, repeat), sp, sc) in enumerate(zip(cfg.stages, P["stages"], caches)):
        per_repeat = []
        for r_ in range(repeat):
            spr, scr = _index(sp, r_), _index(sc, r_)
            for pi, (layer, lp) in enumerate(zip(pattern, spr)):
                cache = scr[pi]["mix"]
                slots = None if split else host_slots(cache, lens[si][pi], r_, layer.window)
                for i, row in enumerate(run):
                    xs[i] = layer_decode_rows(lp, cfg, layer, row, xs[i], pos[i], cache, st,
                                              slots)
            per_repeat.append(tuple({"mix": _renew_tree(c["mix"], st)} for c in scr))
            st.new.clear()
        new_caches.append(_stack(per_repeat))
    first = run[0]
    logits = [gather_logits(row, cfg, head_rows(P, cfg, row, x)) for row, x in zip(run, xs)]
    if split:
        absent_rows(run, logits[0].numel() * logits[0].element_size(), "data_gather")
    out = torch.cat([move(t, row.idx[0], first.idx[0], grid, "data_gather")
                     for row, t in zip(run, logits)])
    return out, new_caches
