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
* MoE layers go through ``moe.moe_ep_row`` with the row's tokens.

A leaf replicated over the model axis is read only at home, so the
gradient of each of its copies, summed over the copies
(``context.reduce_replicas``), is the leaf's gradient. A tree of whole
leaves is laid out on the fly (``sharding.lay_out``, differentiable), so
its gradients are whole leaves. Every layer runs under ``at_entry`` of the
entry that computes it, for the dry run's count. rwkv6 and hymba mixers
raise: their plans are ROADMAP item 12b.
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
from repro_torch.models.mla import mla_core
from repro_torch.models.norms import apply_norm, rmsnorm


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the grid path does not run."""
    for layer in cfg.layer_list():
        if layer.mixer in ("rwkv6", "hymba") or layer.ffn == "rwkv_cm":
            raise NotImplementedError(
                f"{cfg.name}: the {layer.mixer} mixer's sharding plan does not run across a "
                "grid yet (ROADMAP item 12b); train it under a 1x1 grid")


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


def take_cols(row: Row, pieces: list, m: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) (the last dim) of the tensor that ``pieces``
    partition, on entry m: its own piece as it is, the rest gathered."""
    parts = []
    for j, plo, t in pieces:
        a, z = max(lo, plo), min(hi, plo + t.shape[-1])
        if a < z:
            part = t if (a, z) == (plo, plo + t.shape[-1]) else t[..., a - plo:z - plo]
            parts.append(move(part, row.idx[j], row.idx[m], row.grid, "model_gather"))
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


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


def attn_rows(p: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, h: torch.Tensor,
              positions: torch.Tensor, *, train: bool, vq_noise) -> tuple:
    """``attention.attn_apply`` on the row (σ through the ``gated_attention``
    kernel on each entry's device, softmax plain)."""
    b, n, _ = h.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rep = H // Hkv
    xs, ps = row.scatter(h), row.scatter(positions)
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
    return _vq_and_mix(p, cfg, row, outs, H * dh, train, vq_noise)


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


def layer_rows(lp: dict, cfg: ArchConfig, layer: LayerCfg, row: Row, x: torch.Tensor,
               positions: torch.Tensor, noise: Optional[torch.Tensor], *,
               train: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``transformer._layer_fwd`` on the row: (x, the layer's aux)."""
    with row.at(0):
        h = apply_norm(cfg.norm, at_home(lp["norm1"], row), x)
    mixer = mla_rows if layer.mixer == "mla" else attn_rows
    mix, aux = mixer(lp["mixer"], cfg, layer, row, h, positions, train=train, vq_noise=noise)
    with row.at(0):
        x = x + mix
        h2 = apply_norm(cfg.norm, at_home(lp["norm2"], row), x)
    if layer.ffn == "moe":
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


def _noise(cfg: ArchConfig, shape: tuple, li: int, gen, vq_noise, rows: list) -> list:
    """Layer ``li``'s Gumbel noise for the global batch (``vq_noise[li]``,
    else drawn from ``gen`` as ``transformer._layer_noise`` draws it), each
    row's slice on its home; None without VQ."""
    if cfg.vqt is None:
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
    check_supported(cfg)
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
                noise = (_noise(cfg, shape, li, rng, vq_noise, rows) if train
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

