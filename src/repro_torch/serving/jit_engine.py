"""Static-capacity incremental inference for the VQ-Transformer edit
algebra — the PyTorch port of ``repro/serving/jit_engine.py``.

Same algorithm, state layout and contracts as the reference (read its
module docstring for the slot-buffer design): every document lives in a
fixed ``n_cap``-slot buffer with a ``valid`` mask and gapped position ids;
one fixed-shape step applies up to ``C`` typed edits (replace / insert /
delete), patches each layer's accumulated scores column-wise, requantizes,
and propagates at most ``R`` changed rows per layer, reporting ``overflow``
when more changed.

What differs from the reference:

* every step is written out over a leading document axis ``[B]`` (the
  reference's ``vmap``); a single document is the case B=1, and the
  batched engine (``batch_engine.py``) calls the same code;
* it runs eagerly (no ``jit``), with no host synchronisation inside a step:
  no ``.item()``, no boolean-mask indexing, no ``nonzero``;
* the reference's ``mode="drop"`` scatters become scatters whose masked
  lanes land on one dump row past the end (``_put``), which is cut off —
  never index -1, which would wrap to the last slot;
* ``jax.lax.top_k`` over 0/1 scores (lowest index first among ties) becomes
  a sort over unique keys with the same order;
* with ``use_fused_kernel=True`` each layer's patch + T accumulate +
  requantize is one launch of the hand-written CUDA kernel
  (``kernels/fused_step``), and the ``delta_threshold`` gate is one launch
  of the ``delta_gate`` kernel; with ``use_patch_kernel=True`` (and the
  fused kernel off) only the column patch is a kernel (``kernels/incr_patch``)
  and the requantize and the gate's compare stay inline. On CPU tensors
  every kernel runs its plain PyTorch version.

``export_kv`` gathers a state's cached k/v into sequence order (``KVExport``),
the bridge to the decode caches of suggestion serving (``suggest.py``).

State layout per document (``JitState``; batched leaves gain a leading
``[B]``): tokens/positions ``[n_cap]`` int32, valid ``[n_cap]`` bool,
n_real ``[]`` int32, x ``[L+1, n_cap, d]``, q/k/v ``[L, n_cap, H, dh]``,
vc/T ``[L, n_cap, H, Q]`` f32, codes ``[L, n_cap, hq]`` int32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.fused_step import delta_gate, fused_patch_assign_batched
from repro_torch.kernels.incr_patch import incr_patch_batched

# Edit opcodes for the generic ``apply_edits`` step (int32 bucket entries).
OP_REPLACE = 0
OP_INSERT = 1
OP_DELETE = 2


class JitState(NamedTuple):
    tokens: torch.Tensor  # [n_cap] int32
    positions: torch.Tensor  # [n_cap] int32 (gapped ids; order == sequence order)
    valid: torch.Tensor  # [n_cap] bool
    n_real: torch.Tensor  # [] int32
    x: torch.Tensor  # [L+1, n_cap, d]
    q: torch.Tensor  # [L, n_cap, H, dh]
    k: torch.Tensor
    v: torch.Tensor
    vc: torch.Tensor  # [L, n_cap, H, Q]
    T: torch.Tensor  # [L, n_cap, H, Q]
    codes: torch.Tensor  # [L, n_cap, hq]


class KVExport(NamedTuple):
    """Position-ordered view of a slot buffer's cached keys/values. All
    leaves keep the ``n_cap`` extent: the first ``n_real`` rows are the
    valid slots in sequence (position-id) order, the tail rows are invalid
    slots' garbage, which a decode cache masks with its length counter.
    Columns the incremental passes never touched are bit-exact against the
    document's last full forward; touched columns are float-close only."""

    tokens: torch.Tensor  # [n_cap] int32, sequence-ordered (valid rows first)
    positions: torch.Tensor  # [n_cap] int32
    order: torch.Tensor  # [n_cap] int32 — slot index per sequence rank
    k: torch.Tensor  # [L, n_cap, H, dh] sequence-ordered cached keys
    v: torch.Tensor  # [L, n_cap, H, dh]
    n_real: torch.Tensor  # [] int32


# ---------------------------------------------------------------- host copies


def state_to_host(state: JitState) -> JitState:
    """Snapshot a state into host-owned numpy arrays (eager copies: no leaf
    shares storage with a device buffer)."""
    return JitState(*(leaf.detach().cpu().numpy().copy() for leaf in state))


def state_from_host(host_state: JitState, device) -> JitState:
    """Re-upload a ``state_to_host`` snapshot, bit-exactly. ``torch.tensor``
    copies, so the result never aliases the host arrays."""
    dev = resolve_device(device)
    return JitState(*(torch.tensor(np.asarray(leaf), device=dev)
                      for leaf in host_state))


def state_nbytes(state: JitState) -> int:
    """Exact byte footprint of one document's state."""
    return sum(leaf.numel() * leaf.element_size() for leaf in state)


def state_nbytes_for(n_cap: int, n_layers: int, meta: dict) -> int:
    """``state_nbytes`` from shapes alone — what a capacity-``n_cap``
    document WILL occupy. ``meta`` is the engine's weight metadata."""
    L, d, H, dh, Q, hq = (n_layers, meta["d"], meta["H"], meta["dh"],
                          meta["Q"], meta["hq"])
    f32 = 4
    return (
        n_cap * 4            # tokens int32
        + n_cap * 4          # positions int32
        + n_cap * 1          # valid bool
        + 4                  # n_real int32
        + (L + 1) * n_cap * d * f32          # x
        + 3 * L * n_cap * H * dh * f32       # q, k, v
        + 2 * L * n_cap * H * Q * f32        # vc, T
        + L * n_cap * hq * 4                 # codes int32
    )


def state_nbytes_for_config(cfg: ArchConfig, n_cap: int) -> int:
    """``state_nbytes_for`` straight from an ``ArchConfig``."""
    if cfg.vqt is None:
        raise ValueError("state sizing requires a VQT config")
    meta = dict(d=cfg.d_model, H=cfg.n_heads, dh=cfg.resolved_head_dim,
                Q=cfg.vqt.codebook_size, hq=cfg.vqt.n_heads)
    return state_nbytes_for(n_cap, cfg.n_layers, meta)


# ---------------------------------------------------------------- weights


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _index_tree(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_tree(v, r) for v in tree)
    return _np(tree)[r]


def weights_from_params(params: dict, cfg: ArchConfig, *, device="cuda"):
    """Flatten the reference-layout parameters (nested dict of numpy arrays,
    or CPU/GPU tensors; ``mixer.vq`` as ``{"codebook": ...}``) into the
    engine's per-layer stacks ``(W, extras, meta)``.

    Same keys, shapes, head order and arithmetic as
    ``repro/serving/jit_engine.py:_weights_from_params`` (through
    ``repro/core/incremental.py:IncrementalEngine``): the extraction runs in
    numpy on the host, so the same inputs give bitwise-equal weights, then
    moves to ``device``. ``cb_per_head`` fixes the head order
    ``h = hh * heads_per_vq + j`` the fused kernel relies on;
    ``c_wo = C @ W_o`` per vq head and ``vq_bias = -||C||^2 / 2``."""
    dev = resolve_device(device)
    if cfg.vqt is None or cfg.attn_softmax:
        raise ValueError("the engine serves VQT configs (σ attention + VQ)")
    if cfg.pos not in ("learned", "sampled"):
        raise ValueError("VQT uses absolute positional embeddings")
    for layer in cfg.layer_list():
        if layer.mixer != "gqa" or layer.ffn != "gelu":
            raise ValueError(
                "the engine serves the paper's OPT-style blocks; got "
                f"mixer={layer.mixer} ffn={layer.ffn}")
    if cfg.n_kv_heads != cfg.n_heads:
        raise ValueError("the engine assumes MHA (OPT)")
    H, dh, d = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
    hq, Q = cfg.vqt.n_heads, cfg.vqt.codebook_size
    if H % hq:
        raise ValueError("attention heads must split evenly across VQ heads")
    g = H // hq
    d_vq = H * dh // hq
    f32 = lambda a: np.asarray(a, np.float32)

    layers = []
    for (pattern, repeat), sp in zip(cfg.stages, params["stages"]):
        for r in range(repeat):
            layers.extend(_index_tree(sp, r))
    cols = {k: [] for k in ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv",
                            "bv", "bo", "ln2_s", "ln2_b", "w_up", "b_up",
                            "w_down", "b_down", "cb_per_head", "vq_bias",
                            "c_wo")}
    for lp in layers:
        mp = lp["mixer"]
        cb = f32(mp["vq"]["codebook"])  # [hq, Q, d_vq]
        wo = f32(mp["wo"])  # [H*dh, d]
        row = {
            "ln1_s": f32(lp["norm1"]["scale"]), "ln1_b": f32(lp["norm1"]["bias"]),
            "wq": f32(mp["wq"]).reshape(d, H, dh), "bq": f32(mp["bq"]).reshape(H, dh),
            "wk": f32(mp["wk"]).reshape(d, H, dh), "bk": f32(mp["bk"]).reshape(H, dh),
            "wv": f32(mp["wv"]).reshape(d, H, dh), "bv": f32(mp["bv"]).reshape(H, dh),
            "bo": f32(mp["bo"]),
            "ln2_s": f32(lp["norm2"]["scale"]), "ln2_b": f32(lp["norm2"]["bias"]),
            "w_up": f32(lp["ffn"]["w_up"]), "b_up": f32(lp["ffn"]["b_up"]),
            "w_down": f32(lp["ffn"]["w_down"]), "b_down": f32(lp["ffn"]["b_down"]),
            "cb_per_head": cb.reshape(hq, Q, g, dh).transpose(0, 2, 1, 3)
            .reshape(H, Q, dh),
            "vq_bias": -0.5 * np.sum(cb ** 2, axis=-1),
            "c_wo": np.einsum("hqv,hvd->hqd", cb, wo.reshape(hq, d_vq, d)),
        }
        for k, v in row.items():
            cols[k].append(v)
    to_dev = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(dev)
    W = {k: to_dev(np.stack(v)) for k, v in cols.items()}
    tok = f32(params["embed"]["tok"])
    head_w = tok.T if cfg.tie_embeddings else f32(params["lm_head"])
    extras = {
        "tok_emb": to_dev(tok), "pos_emb": to_dev(f32(params["embed"]["pos"])),
        "fn_s": to_dev(f32(params["final_norm"]["scale"])),
        "fn_b": to_dev(f32(params["final_norm"]["bias"])),
        "head_w": to_dev(head_w),
    }
    meta = dict(H=H, dh=dh, d=d, hq=hq, Q=Q, heads_per_vq=g,
                scale=float(np.float32(dh ** -0.5)))
    return W, extras, meta


# ---------------------------------------------------------------- pieces


def _ln(x, s, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # population variance, as jnp
    return (x - mu) / torch.sqrt(var + eps) * s + b


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _order_masks(positions: torch.Tensor, valid: torch.Tensor):
    """Causal structure of [B, n] slot buffers from position-id order:
    causal[b, i, j] = valid[b, j] & (positions[b, j] <= positions[b, i]);
    counts = attended columns per row, clamped to 1."""
    causal = ((positions[:, None, :] <= positions[:, :, None])
              & valid[:, None, :]).to(torch.float32)  # [B, n(rows), n(cols)]
    counts = torch.clamp(causal.sum(-1), min=1.0)  # [B, n]
    return causal, counts


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, ...] gathered at idx [B, k] -> [B, k, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def _put(base: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
         values) -> torch.Tensor:
    """A copy of ``base`` [B, n, ...] with ``base[b, idx[b, j]] = values[b, j]``
    where ``keep[b, j]`` — the reference's ``.at[...].set(mode="drop")``.
    Masked lanes write one dump row past the end, which is cut off."""
    B, n = base.shape[:2]
    rest = base.shape[2:]
    flat = torch.cat([base.reshape(B * n, *rest), base.new_zeros((1, *rest))])
    offs = torch.arange(B, device=base.device)[:, None] * n
    tgt = torch.where(keep, idx + offs, B * n).reshape(-1)
    if isinstance(values, torch.Tensor):
        values = values.reshape(-1, *rest).to(base.dtype)
    flat[tgt] = values
    return flat[:B * n].view(B, n, *rest)


def sequence_order(valid: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Slot indices in sequence (position-id) order along the last axis,
    invalid slots last: their position ids may hold the pool sentinel, so
    the sort key is lifted above every real id. The sort is stable, so the
    invalid tail keeps slot order — the host-side order
    ``SuggestionEngine.refresh`` computes."""
    big = torch.iinfo(torch.int32).max
    return torch.argsort(torch.where(valid, positions, big), dim=-1, stable=True)


def _dense(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] bool with True at idx[b, j] where keep[b, j]."""
    base = torch.zeros(idx.shape[0], n, dtype=torch.bool, device=idx.device)
    return _put(base, idx, keep, True)


class JitIncrementalEngine:
    """Static-capacity incremental engine for the full VQT edit algebra.

    ``params`` is the reference-layout parameter dict (``weights_from_params``)
    or ignored when ``_weights=(W, extras, meta)`` shares another engine's
    stacks. ``device`` defaults to ``"cuda"`` and never falls back."""

    def __init__(self, params: dict, cfg: ArchConfig, *, edit_capacity: int = 8,
                 row_capacity: int = 64, use_patch_kernel: bool = False,
                 use_fused_kernel: bool = False, delta_threshold: float = 0.0,
                 device="cuda", _weights=None):
        self.cfg = cfg
        self.C = edit_capacity
        self.R = row_capacity
        self.device = resolve_device(device)
        if (self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise ValueError(
                "torch.backends.cuda.matmul.allow_tf32 is True: TF32 matmuls "
                "flip VQ codes; set it to False before serving")
        # the column patch through the incr_patch kernel (same math)
        self.use_patch_kernel = use_patch_kernel
        # one fused_step launch per layer (patch + T accumulate + requantize);
        # subsumes use_patch_kernel
        self.use_fused_kernel = use_fused_kernel
        # sigma-delta gate (DESIGN.md §10); 0.0 runs the ungated step exactly
        if delta_threshold < 0.0:
            raise ValueError("delta_threshold must be >= 0")
        self.delta_threshold = float(delta_threshold)
        if _weights is not None:
            self.W, self.extras, self.meta = _weights
        else:
            self.W, self.extras, self.meta = weights_from_params(
                params, cfg, device=self.device)
        self.L = self.W["wq"].shape[0]

    @property
    def weights(self):
        """(W, extras, meta) — pass as ``_weights=`` to share the stacks."""
        return self.W, self.extras, self.meta

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        """``a`` on the engine's device as ``dtype``; host arrays are always
        copied, so a state never aliases a caller's (mutable) mirror."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ layer parts

    def _requantize(self, T, counts, li):
        """codes = argmax_Q(Σ_heads T / counts + vq_bias) over [B, n, H, Q]."""
        m = self.meta
        B, n = T.shape[:2]
        s = T.reshape(B, n, m["hq"], m["heads_per_vq"], m["Q"]).sum(3)
        s = s / counts[:, :, None, None] + self.W["vq_bias"][li]
        return torch.argmax(s, dim=-1).to(torch.int32)

    def _attn_out(self, codes, li):
        """bo + Σ_hh c_wo[hh][codes[..., hh]], in the reference's order."""
        c_wo = self.W["c_wo"][li]
        return self.W["bo"][li] + sum(
            c_wo[hh][codes[..., hh].long()] for hh in range(self.meta["hq"]))

    def _ffn_block(self, x_mid, li):
        W = self.W
        h2 = _ln(x_mid, W["ln2_s"][li], W["ln2_b"][li])
        ffn = (_gelu(h2 @ W["w_up"][li] + W["b_up"][li]) @ W["w_down"][li]
               + W["b_down"][li])
        return x_mid + ffn

    def _qkv(self, x_rows, li):
        W = self.W
        h = _ln(x_rows, W["ln1_s"][li], W["ln1_b"][li])
        q = torch.einsum("bcd,dhe->bche", h, W["wq"][li]) + W["bq"][li]
        k = torch.einsum("bcd,dhe->bche", h, W["wk"][li]) + W["bk"][li]
        v = torch.einsum("bcd,dhe->bche", h, W["wv"][li]) + W["bv"][li]
        vc = torch.einsum("bche,hqe->bchq", v, W["cb_per_head"][li])
        return q, k, v, vc

    # ------------------------------------------------------------ full pass

    def full_forward(self, tokens, positions, valid=None) -> JitState:
        """Ingest one slot buffer ([n_cap] arrays). ``valid=None`` means
        every slot is real."""
        if valid is not None:
            valid = self._tensor(valid, torch.bool)[None]
        st = self._batch_full_forward(self._tensor(tokens)[None],
                                      self._tensor(positions)[None], valid)
        return JitState(*(leaf[0] for leaf in st))

    def _batch_full_forward(self, tokens, positions, valid=None) -> JitState:
        m = self.meta
        tokens, positions = self._tensor(tokens), self._tensor(positions)
        valid = (torch.ones(tokens.shape, dtype=torch.bool, device=self.device)
                 if valid is None else self._tensor(valid, torch.bool))
        x = self.extras["tok_emb"][tokens] + self.extras["pos_emb"][positions]
        causal, counts = _order_masks(positions, valid)
        xs, qs, ks, vs, vcs, Ts, cds = [x], [], [], [], [], [], []
        for li in range(self.L):
            q, k, v, vc = self._qkv(x, li)
            w = _gelu(torch.einsum("bnhe,bjhe->bhnj", q, k) * m["scale"]) \
                * causal[:, None]
            T = torch.einsum("bhnj,bjhq->bnhq", w, vc)
            codes = self._requantize(T, counts, li)
            x = self._ffn_block(x + self._attn_out(codes, li), li)
            xs.append(x)
            qs.append(q); ks.append(k); vs.append(v)
            vcs.append(vc); Ts.append(T); cds.append(codes)
        st = lambda l: torch.stack(l, dim=1)
        return JitState(tokens.to(torch.int32), positions.to(torch.int32),
                        valid, valid.sum(-1, dtype=torch.int32),
                        st(xs), st(qs), st(ks), st(vs), st(vcs), st(Ts), st(cds))

    # ------------------------------------------------------------ edit step

    def apply_edits(self, state: JitState, slot, tok, pos_id, op):
        """Up to ``C`` typed edits on one document: slot/tok/pos_id/op [C]
        (pad unused slots with -1). Returns (new_state, overflow [] bool);
        overflow=True means the propagation bucket R was exceeded at some
        layer and the result is UNRELIABLE (caller must full_forward)."""
        batched = JitState(*(leaf[None] for leaf in state))
        new, overflow = self._batch_apply_edits(
            batched, *(self._tensor(a)[None] for a in (slot, tok, pos_id, op)))
        return JitState(*(leaf[0] for leaf in new)), overflow[0]

    def apply_replaces(self, state, edit_pos, edit_tok):
        z = torch.zeros_like(self._tensor(edit_pos))
        return self.apply_edits(state, edit_pos, edit_tok, z, z)

    def apply_inserts(self, state, slot, tok, pos_id):
        slot = self._tensor(slot)
        op = torch.where(slot >= 0, OP_INSERT, 0)
        return self.apply_edits(state, slot, tok, pos_id, op)

    def apply_deletes(self, state, slot):
        slot = self._tensor(slot)
        z = torch.zeros_like(slot)
        op = torch.where(slot >= 0, OP_DELETE, 0)
        return self.apply_edits(state, slot, z, z, op)

    def _batch_apply_edits(self, state: JitState, slot, tok, pos_id, op):
        """The step over [B] documents: slot/tok/pos_id/op [B, C] int64 on
        the engine's device. Returns (new_state, overflow [B] bool)."""
        m, W, E = self.meta, self.W, self.extras
        B, n = state.tokens.shape
        dev = self.device
        valid_e = slot >= 0
        slot_safe = torch.where(valid_e, slot, 0)
        opv = torch.where(valid_e, op, -1)
        is_ins = opv == OP_INSERT
        is_del = opv == OP_DELETE
        has_new = valid_e & ~is_del  # slot holds a (new) token afterwards
        had_old = valid_e & ~is_ins  # slot contributed a column before

        # -------- slot metadata. Deleted slots keep their position id: the
        # patch still needs it to address the rows that attended the column.
        tokens = _put(state.tokens, slot_safe, has_new, tok)
        positions = _put(state.positions, slot_safe, is_ins, pos_id)
        valid = _put(state.valid, slot_safe, is_ins, True)
        valid = _put(valid, slot_safe, is_del, False)
        n_real = (state.n_real + is_ins.sum(-1, dtype=torch.int32)
                  - is_del.sum(-1, dtype=torch.int32))
        causal, counts = _order_masks(positions, valid)
        row_valid = valid.to(torch.float32)

        # Inserted slots may hold a stale tenant's activations: their k/vc
        # read as zero at every layer, so the "old contribution" the patch
        # subtracts is exactly zero (gelu(0)·0 = 0).
        ins_rows = _dense(slot_safe, is_ins, n)[:, :, None, None]

        # layer-0 dirty bucket = the edit bucket
        x_rows = (E["tok_emb"][_rows(tokens, slot_safe).long()]
                  + E["pos_emb"][_rows(positions, slot_safe).long()])
        new_x = [_put(state.x[:, 0], slot_safe, has_new, x_rows)]
        dirty_idx, new_mask = slot_safe, has_new
        # columns to patch: the row set at layer 0, row set ∪ deleted slots
        # below (a deleted slot's cached k/vc sit in every layer's T sums)
        col_idx, col_old, col_new = slot_safe, had_old, has_new
        new_q, new_k, new_v, new_vc, new_T, new_codes = [], [], [], [], [], []
        overflow = torch.zeros(B, dtype=torch.bool, device=dev)
        k_sel = min(self.R, n)
        ar = torch.arange(n, device=dev).expand(B, n)

        for li in range(self.L):
            x_in = new_x[li]
            q_n, k_n, v_n, vc_n = self._qkv(_rows(x_in, dirty_idx), li)
            k_base = torch.where(ins_rows, 0.0, state.k[:, li])
            vc_base = torch.where(ins_rows, 0.0, state.vc[:, li])
            q_all = _put(state.q[:, li], dirty_idx, new_mask, q_n)
            k_all = _put(k_base, dirty_idx, new_mask, k_n)
            v_all = _put(state.v[:, li], dirty_idx, new_mask, v_n)
            vc_all = _put(vc_base, dirty_idx, new_mask, vc_n)
            k_old = _rows(k_base, col_idx)
            vc_old = _rows(vc_base, col_idx) * col_old[:, :, None, None]
            k_new = _rows(k_all, col_idx)
            vc_new = _rows(vc_all, col_idx) * col_new[:, :, None, None]

            # column patch over ALL rows, gated by column liveness, causal
            # position order and row validity
            col_mask = ((col_old | col_new)[:, None, :]
                        & (_rows(positions, col_idx)[:, None, :]
                           <= positions[:, :, None])).to(torch.float32)
            # dirty rows: full row recompute (their causal row already
            # reflects inserts/deletes)
            w_rows = _gelu(torch.einsum("bche,bjhe->bhcj",
                                        _rows(q_all, dirty_idx), k_all)
                           * m["scale"]) * _rows(causal, dirty_idx)[:, None]
            T_rows = torch.einsum("bhcj,bjhq->bchq", w_rows, vc_all)
            if self.use_fused_kernel:
                # one launch: the mask folds every gate (live columns, causal
                # order, row validity, dirty-row exclusion); the dirty rows'
                # recompute is pre-scattered into T_base
                dirty = _dense(dirty_idx, new_mask, n).to(torch.float32)
                pmask = col_mask * (row_valid * (1.0 - dirty))[:, :, None]
                T_base = _put(state.T[:, li], dirty_idx, new_mask, T_rows)
                T_all, codes = fused_patch_assign_batched(
                    state.q[:, li].contiguous(),
                    k_new.transpose(1, 2).contiguous(),
                    k_old.transpose(1, 2).contiguous(),
                    vc_new.transpose(1, 2).contiguous(),
                    vc_old.transpose(1, 2).contiguous(),
                    pmask, T_base, counts, W["vq_bias"][li],
                    heads_per_vq=m["heads_per_vq"])
            else:
                if self.use_patch_kernel:
                    # one incr_patch launch; row validity folds into the mask
                    dT = incr_patch_batched(
                        state.q[:, li].contiguous(),
                        k_new.transpose(1, 2).contiguous(),
                        k_old.transpose(1, 2).contiguous(),
                        vc_new.transpose(1, 2).contiguous(),
                        vc_old.transpose(1, 2).contiguous(),
                        col_mask, row_valid=row_valid)
                else:
                    cm = (col_mask * row_valid[:, :, None])[:, :, None, :]
                    q_l = state.q[:, li]
                    s_new = torch.einsum("bnhe,bche->bnhc", q_l, k_new) * m["scale"]
                    s_old = torch.einsum("bnhe,bche->bnhc", q_l, k_old) * m["scale"]
                    dT = (torch.einsum("bnhc,bchq->bnhq", _gelu(s_new) * cm, vc_new)
                          - torch.einsum("bnhc,bchq->bnhq", _gelu(s_old) * cm, vc_old))
                T_all = _put(state.T[:, li] + dT, dirty_idx, new_mask, T_rows)
                codes = self._requantize(T_all, counts, li)

            changed = (codes != state.codes[:, li]).any(-1) & valid
            changed = _put(changed, dirty_idx, new_mask, True)
            overflow = overflow | (changed.sum(-1) > self.R)

            # up to R changed rows, lowest slot first (jax.lax.top_k's order
            # over 0/1 scores), then unchanged rows as padding
            next_idx = torch.argsort(torch.where(changed, ar, ar + n),
                                     dim=-1)[:, :k_sel]
            next_valid = _rows(changed, next_idx)
            x_mid = _rows(x_in, next_idx) + self._attn_out(
                _rows(codes, next_idx), li)
            x_out_rows = self._ffn_block(x_mid, li)

            keep = next_valid
            if self.delta_threshold > 0.0:
                # sigma-delta gate: a row propagates only if its recompute
                # drifted past the threshold from the value it last
                # transmitted (the stored x[li+1] row)
                x_prev_rows = _rows(state.x[:, li + 1], next_idx)
                if self.use_fused_kernel:
                    moved = delta_gate(
                        x_out_rows.reshape(B * k_sel, -1),
                        x_prev_rows.reshape(B * k_sel, -1),
                        self.delta_threshold).view(B, k_sel)
                else:
                    moved = ((x_out_rows - x_prev_rows).abs().amax(-1)
                             > self.delta_threshold)
                keep = next_valid & moved

            new_x.append(_put(state.x[:, li + 1], next_idx, keep, x_out_rows))
            new_q.append(q_all); new_k.append(k_all); new_v.append(v_all)
            new_vc.append(vc_all); new_T.append(T_all); new_codes.append(codes)
            dirty_idx, new_mask = next_idx, keep
            # deeper layers: propagated rows patch old→new; deleted slots
            # keep riding along as old-only columns
            col_idx = torch.cat([next_idx, slot_safe], dim=1)
            col_old = torch.cat([keep, is_del], dim=1)
            col_new = torch.cat([keep, torch.zeros_like(is_del)], dim=1)

        st = lambda l: torch.stack(l, dim=1)
        return JitState(tokens, positions, valid, n_real, st(new_x), st(new_q),
                        st(new_k), st(new_v), st(new_vc), st(new_T),
                        st(new_codes)), overflow

    # ------------------------------------------------------- state surgery

    def pad_state(self, state: JitState, new_cap: int,
                  pos_fill: int = 0) -> JitState:
        """Grow one document's buffers to a larger capacity class: appended
        slots are free (valid=False, position ``pos_fill``, token 0, zero
        activations); existing slots keep their bits."""
        n = state.tokens.shape[0]
        if new_cap < n:
            raise ValueError(f"pad_state cannot shrink ({n} -> {new_cap})")
        extra = new_cap - n

        def pad(a, axis, fill=0):
            shape = list(a.shape)
            shape[axis] = extra
            return torch.cat([a, torch.full(shape, fill, dtype=a.dtype,
                                            device=a.device)], dim=axis)

        return JitState(
            tokens=pad(state.tokens, 0), positions=pad(state.positions, 0, pos_fill),
            valid=pad(state.valid, 0), n_real=state.n_real,
            x=pad(state.x, 1), q=pad(state.q, 1), k=pad(state.k, 1),
            v=pad(state.v, 1), vc=pad(state.vc, 1), T=pad(state.T, 1),
            codes=pad(state.codes, 1))

    def gather_slots(self, state: JitState, order) -> JitState:
        """Permute the slot axis of every leaf by ``order`` ([n_cap], a
        permutation) — defrag compaction on the device."""
        order = self._tensor(order)
        take = lambda a, axis: torch.index_select(a, axis, order)
        return JitState(
            tokens=take(state.tokens, 0), positions=take(state.positions, 0),
            valid=take(state.valid, 0), n_real=state.n_real,
            x=take(state.x, 1), q=take(state.q, 1), k=take(state.k, 1),
            v=take(state.v, 1), vc=take(state.vc, 1), T=take(state.T, 1),
            codes=take(state.codes, 1))

    # ------------------------------------------------------------ kv export

    def export_kv(self, state: JitState) -> KVExport:
        """Gather one document's cached k/v into sequence order — the
        ``JitState -> KV cache`` bridge for suggestion decoding."""
        order = sequence_order(state.valid, state.positions)
        return KVExport(tokens=state.tokens[order], positions=state.positions[order],
                        order=order.to(torch.int32),
                        k=torch.index_select(state.k, 1, order),
                        v=torch.index_select(state.v, 1, order),
                        n_real=state.n_real)

    # ------------------------------------------------------------ outputs

    def logits_last(self, state: JitState) -> torch.Tensor:
        """Logits [vocab] at the last slot (``logits_at`` of slot -1)."""
        return self.logits_at(state, -1)

    def logits_at(self, state: JitState, index) -> torch.Tensor:
        """Logits [vocab] at slot ``index`` (the slot of the document's last
        valid row in position order — the host scheduler tracks it)."""
        h = _ln(state.x[-1][int(index)][None], self.extras["fn_s"],
                self.extras["fn_b"])[0]
        return h @ self.extras["head_w"]
