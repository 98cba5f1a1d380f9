"""The paper's incremental-inference engine for VQ-Transformers (§3, App. A)
— the PyTorch port of ``repro/core/incremental.py``.

Processes *edits* to a cached document instead of re-running the model:

* per-location ops (norms, QKV/FFN projections) run only at *dirty*
  positions (§3.2);
* self-attention is patched row/column-wise (App. A.1): an edited position
  contributes one changed query row (recompute that row) and one changed
  key/value column (patch all later rows' accumulated sums);
* the VQ score trick (App. A.2): the engine tracks the per-row *codebook
  scores* ``T[i,h,c] = Σ_j w[h,i,j] · (v[j,h]·C_c)`` instead of the
  attention output, so re-quantization after a patch costs O(q) per row,
  and the quantized output is rebuilt from the precomputed ``C @ W_o``
  table in O(h·d);
* positions whose VQ code did **not** change stop propagating. The dirty
  set of layer l+1 is ``{code changed} ∪ {residual input changed}``.

The paper's metric is *counted arithmetic operations*: every operation is
metered through ``OpCounter`` at the same place and with the same sizes as
the reference, with the conventions of the dense baseline
(``opcount.dense_transformer_forward_ops``). So a per-edit count depends
only on the dirty sets, and through them only on the VQ codes.

What differs from the reference:

* activations (``DocState.xs`` and every ``LayerState`` tensor) live on
  the engine's ``device``, which defaults to ``"cuda"`` and never falls
  back to the CPU;
* index sets — dirty, later, affected and changed rows, and the document's
  tokens and position ids — stay host int64 numpy arrays: the counter needs
  their sizes, ``np.union1d`` / ``np.setdiff1d`` keep them sorted and
  unique, and the position allocator and the aligner read them. Each layer
  of an edit moves them to the device as index tensors and copies one
  boolean vector back (which affected rows changed code);
* the weights are ``serving/jit_engine.weights_from_params``'s per-layer
  stacks, indexed per layer (the same numpy extraction as the reference).

Exactness invariant: the incremental state equals ``full_forward`` of the
edited document — the same codes, hidden states equal to float tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.edits import Edit, align
from repro_torch.core.opcount import OpCounter
from repro_torch.core.positional import spread_positions
from repro_torch.serving.jit_engine import weights_from_params

_SQRT_2_OVER_PI = float(np.sqrt(2.0 / np.pi).astype(np.float32))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU, written out in the reference's order."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x ** 3)))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps=1e-5) -> torch.Tensor:
    if x.shape[0] == 0:  # no rows to normalize (torch.var warns on them)
        return x.clone()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)  # population variance, as np.var
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _insert_row(a: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([a[:p], a.new_zeros((1, *a.shape[1:])), a[p:]])


def _delete_row(a: torch.Tensor, p: int) -> torch.Tensor:
    return torch.cat([a[:p], a[p + 1:]])


@dataclass
class LayerState:
    """Cached per-layer activations for one document (on the device)."""

    q: torch.Tensor  # [n, H, dh]
    k: torch.Tensor
    v: torch.Tensor
    vc: torch.Tensor  # [n, H, Q] per-head value·codebook inner products
    T: torch.Tensor  # [n, H, Q] accumulated w̃·vc sums (unnormalized scores)
    codes: torch.Tensor  # [n, hq] int32

    FIELDS = ("q", "k", "v", "vc", "T", "codes")

    def copy(self) -> "LayerState":
        return LayerState(*(getattr(self, f).clone() for f in self.FIELDS))

    def to(self, device) -> "LayerState":
        return LayerState(*(getattr(self, f).to(device, copy=True) for f in self.FIELDS))


@dataclass
class DocState:
    tokens: np.ndarray  # [n] int64 (host)
    positions: np.ndarray  # [n] int64 (host; gapped ids, order == sequence order)
    xs: list  # L+1 residual-stream snapshots [n, d] (device)
    layers: list  # list[LayerState]

    @property
    def n(self) -> int:
        return len(self.tokens)

    def copy(self) -> "DocState":
        return DocState(self.tokens.copy(), self.positions.copy(),
                        [x.clone() for x in self.xs], [l.copy() for l in self.layers])

    def to(self, device) -> "DocState":
        """A copy whose tensors live on ``device``."""
        return DocState(self.tokens.copy(), self.positions.copy(),
                        [x.to(device, copy=True) for x in self.xs],
                        [l.to(device) for l in self.layers])


class IncrementalEngine:
    """Incremental inference for a VQT model (gqa mixer, dense GELU FFN,
    σ-attention, multi-head VQ on attention outputs, absolute positional
    embeddings). ``params`` is the reference-layout tree (numpy arrays or
    tensors); ``device`` defaults to ``"cuda"``."""

    def __init__(self, params: dict, cfg: ArchConfig, counter: Optional[OpCounter] = None,
                 *, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise ValueError(
                "torch.backends.cuda.matmul.allow_tf32 is True: TF32 matmuls "
                "flip VQ codes; set it to False first")
        W, extras, meta = weights_from_params(params, cfg, device=self.device)
        self.cfg = cfg
        self.counter = counter if counter is not None else OpCounter()
        self.H, self.dh, self.d = meta["H"], meta["dh"], meta["d"]
        self.hq, self.Q = meta["hq"], meta["Q"]
        self.heads_per_vq = meta["heads_per_vq"]
        self.scale = meta["scale"]  # float32(dh ** -0.5), exactly
        self.tok_emb, self.pos_emb = extras["tok_emb"], extras["pos_emb"]
        self.fn_s, self.fn_b, self.head_w = extras["fn_s"], extras["fn_b"], extras["head_w"]
        # per-layer views of the stacks: self.layers[l]["wq"] is W["wq"][l]
        self.layers = [{k: v[li] for k, v in W.items()} for li in range(W["wq"].shape[0])]

    # ------------------------------------------------------------- helpers

    def _idx(self, rows: np.ndarray) -> torch.Tensor:
        """A host index array as an int64 index tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(self.device)

    def _counts(self, n: int) -> torch.Tensor:
        """Attended columns per row of an n-row document: 1..n."""
        return torch.arange(1, n + 1, dtype=torch.float32, device=self.device)

    def _scores(self, q_rows: torch.Tensor, k_cols: torch.Tensor) -> torch.Tensor:
        """σ-attention weights gelu(q·k · scale) [m, H, j]."""
        return gelu(torch.einsum("mhe,jhe->mhj", q_rows, k_cols) * self.scale)

    # ------------------------------------------------------------- pieces

    def _embed(self, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        self.counter.elementwise("embed", tokens.size * self.d)
        return self.tok_emb[self._idx(tokens)] + self.pos_emb[self._idx(positions)]

    def _qkv_at(self, W: dict, x_rows: torch.Tensor):
        """Per-location: LN1 + QKV projections for a set of rows [m, d]."""
        m = x_rows.shape[0]
        self.counter.elementwise("perloc_ln", m * self.d, 8)
        h = layernorm(x_rows, W["ln1_s"], W["ln1_b"])
        self.counter.matmul("perloc_qkv", m, self.d, 3 * self.H * self.dh)
        q = torch.einsum("md,dhe->mhe", h, W["wq"]) + W["bq"]
        k = torch.einsum("md,dhe->mhe", h, W["wk"]) + W["bk"]
        v = torch.einsum("md,dhe->mhe", h, W["wv"]) + W["bv"]
        return q, k, v

    def _vc_of(self, W: dict, v_rows: torch.Tensor) -> torch.Tensor:
        """v rows [m, H, dh] -> per-attention-head codebook products [m, H, Q]."""
        m = v_rows.shape[0]
        self.counter.matmul("vq_vc", m * self.H, self.dh, self.Q)
        return torch.einsum("mhe,hqe->mhq", v_rows, W["cb_per_head"])

    def _row_scores(self, W: dict, q_rows: torch.Tensor, st: LayerState,
                    row_idx: np.ndarray) -> torch.Tensor:
        """Full row recompute of T for query rows (App. A.1 'altered rows').

        q_rows: [m, H, dh] for rows row_idx (sorted). Returns T rows [m, H, Q].
        """
        m = len(row_idx)
        if m == 0:
            return torch.zeros((0, self.H, self.Q), device=self.device)
        n = st.k.shape[0]
        self.counter.matmul("attn_row_scores", m * self.H, self.dh, n)
        self.counter.elementwise("attn_sigma", m * self.H * n)
        w = self._scores(q_rows, st.k)  # [m, H, n]
        # causal mask: row i attends to j <= i (a multiply, as the reference)
        mask = torch.arange(n, device=self.device)[None, :] <= self._idx(row_idx)[:, None]
        w = w * mask[:, None, :]
        self.counter.matmul("attn_row_accum", m * self.H, n, self.Q)
        return torch.einsum("mhj,jhq->mhq", w, st.vc)

    def _codes_of(self, T_rows: torch.Tensor, W: dict, counts: torch.Tensor) -> torch.Tensor:
        """T rows [m, H, Q] + attended counts [m] -> VQ codes [m, hq]."""
        m = T_rows.shape[0]
        s = T_rows.reshape(m, self.hq, self.heads_per_vq, self.Q).sum(2)  # [m, hq, Q]
        s = s / counts[:, None, None] + W["vq_bias"][None]
        self.counter.elementwise("vq_argmax", m * self.hq * self.Q, 2)
        return torch.argmax(s, dim=-1).to(torch.int32)  # the first maximum, as np.argmax

    def _attn_out(self, W: dict, codes: torch.Tensor) -> torch.Tensor:
        """Quantized attention output via the precomputed C@W_o table [m, d]."""
        m = codes.shape[0]
        self.counter.elementwise("attn_out_lookup", m * self.hq * self.d)
        out = W["bo"][None, :].repeat(m, 1)
        idx = codes.long()
        for h in range(self.hq):
            out += W["c_wo"][h][idx[:, h]]
        return out

    def _ffn_at(self, W: dict, x_rows: torch.Tensor) -> torch.Tensor:
        m = x_rows.shape[0]
        self.counter.elementwise("perloc_ln", m * self.d, 8)
        h = layernorm(x_rows, W["ln2_s"], W["ln2_b"])
        self.counter.matmul("perloc_ffn", m, self.d, self.cfg.d_ff)
        u = h @ W["w_up"] + W["b_up"]
        self.counter.elementwise("ffn_gelu", m * self.cfg.d_ff)
        u = gelu(u)
        self.counter.matmul("perloc_ffn", m, self.cfg.d_ff, self.d)
        return u @ W["w_down"] + W["b_down"]

    def _requantize(self, W: dict, st: LayerState, affected: np.ndarray,
                    counts: torch.Tensor) -> np.ndarray:
        """Re-quantize the affected rows; returns those whose code changed
        (one device-to-host copy: the filter)."""
        aff = self._idx(affected)
        new_codes = self._codes_of(st.T[aff], W, counts[aff])
        moved = (new_codes != st.codes[aff]).any(1).cpu().numpy()
        st.codes[aff] = new_codes
        return affected[moved]

    def _propagate(self, W: dict, st: LayerState, x_in: torch.Tensor,
                   changed: np.ndarray):
        """Rebuild the residual stream at the changed rows only."""
        ch = self._idx(changed)
        x_mid_rows = x_in[ch] + self._attn_out(W, st.codes[ch])
        self.counter.elementwise("residual", len(changed) * self.d)
        x_out_rows = x_mid_rows + self._ffn_at(W, x_mid_rows)
        self.counter.elementwise("residual", len(changed) * self.d)
        return ch, x_out_rows

    def _patch_columns(self, st: LayerState, later: np.ndarray, cols: np.ndarray,
                       k_new, vc_new, k_old, vc_old) -> None:
        """ΔT[i] = Σ_{j∈cols, j<=i} w̃_new[i,j]·vc_new[j] − w̃_old[i,j]·vc_old[j]
        for the (unchanged-query) rows ``later``."""
        lt = self._idx(later)
        q_rows = st.q[lt]
        self.counter.matmul("attn_col_scores", len(later) * self.H, self.dh, 2 * len(cols))
        self.counter.elementwise("attn_sigma", 2 * len(later) * self.H * len(cols))
        mask = (self._idx(cols)[None, :] <= lt[:, None])[:, None, :]  # causal: col j <= row i
        w_new = self._scores(q_rows, k_new) * mask
        w_old = self._scores(q_rows, k_old) * mask
        self.counter.matmul("attn_col_patch", len(later) * self.H, len(cols), 2 * self.Q)
        st.T[lt] += (torch.einsum("mhj,jhq->mhq", w_new, vc_new)
                     - torch.einsum("mhj,jhq->mhq", w_old, vc_old))

    def _patch_one_column(self, st: LayerState, later: np.ndarray, p: int,
                          sign: float) -> None:
        """Add (sign=+1) or remove (sign=-1) column p's contribution to rows
        ``later`` (an insert's new column, a delete's vanished one)."""
        lt = self._idx(later)
        self.counter.matmul("attn_col_scores", len(later) * self.H, self.dh, 1)
        s_p = torch.einsum("mhe,he->mh", st.q[lt], st.k[p]) * self.scale
        self.counter.elementwise("attn_sigma", len(later) * self.H)
        w_p = gelu(s_p)
        self.counter.matmul("attn_col_patch", len(later) * self.H, 1, self.Q)
        if sign > 0:
            st.T[lt] += w_p[..., None] * st.vc[p][None]
        else:
            st.T[lt] -= w_p[..., None] * st.vc[p][None]

    # ------------------------------------------------------------- full pass

    def full_forward(self, tokens: Sequence[int], positions: Sequence[int]) -> DocState:
        tokens = np.asarray(tokens, np.int64)
        positions = np.asarray(positions, np.int64)
        n = len(tokens)
        x = self._embed(tokens, positions)
        xs = [x]
        layers = []
        counts = self._counts(n)
        all_rows = np.arange(n)
        for W in self.layers:
            q, k, v = self._qkv_at(W, x)
            vc = self._vc_of(W, v)
            st = LayerState(q=q, k=k, v=v, vc=vc, T=None, codes=None)  # type: ignore
            st.T = self._row_scores(W, q, st, all_rows)
            st.codes = self._codes_of(st.T, W, counts)
            x = x + self._attn_out(W, st.codes)
            self.counter.elementwise("residual", n * self.d)
            x = x + self._ffn_at(W, x)
            self.counter.elementwise("residual", n * self.d)
            layers.append(st)
            xs.append(x)
        return DocState(tokens, positions, xs, layers)

    # ------------------------------------------------------------- edits

    def apply_replaces(self, state: DocState, pos_list: Sequence[int],
                       new_tokens: Sequence[int]) -> DocState:
        """Batched token replacement (offline revisions collapse to this after
        alignment). Dirty-set propagation per §3.2 / App. A.1."""
        state = state.copy()
        order = np.argsort(np.asarray(pos_list))
        D = np.asarray(pos_list, np.int64)[order]
        state.tokens[D] = np.asarray(new_tokens, np.int64)[order]
        n = state.n
        counts = self._counts(n)

        dirty = D
        x_prev_rows = self._embed(state.tokens[D], state.positions[D])
        for li, W in enumerate(self.layers):
            st = state.layers[li]
            x_in = state.xs[li]
            dt = self._idx(dirty)
            # 1. per-location updates at dirty rows
            old_k, old_vc = st.k[dt], st.vc[dt]
            x_in[dt] = x_prev_rows
            q_new, k_new, v_new = self._qkv_at(W, x_prev_rows)
            vc_new = self._vc_of(W, v_new)
            st.q[dt], st.k[dt], st.v[dt], st.vc[dt] = q_new, k_new, v_new, vc_new
            # 2a. column patches: rows i > min(dirty), i not dirty
            later = np.setdiff1d(np.arange(int(dirty.min()), n), dirty)
            if len(later) > 0:
                self._patch_columns(st, later, dirty, k_new, vc_new, old_k, old_vc)
            # 2b. dirty rows: full row recompute
            st.T[dt] = self._row_scores(W, q_new, st, dirty)
            # 3. re-quantize affected rows; unchanged codes stop here
            affected = np.union1d(later, dirty) if len(later) else dirty
            changed = np.union1d(self._requantize(W, st, affected, counts), dirty)
            # 4. rebuild residual stream at changed rows only
            ch, x_prev_rows = self._propagate(W, st, x_in, changed)
            state.xs[li + 1][ch] = x_prev_rows
            dirty = changed
        return state

    def _renumber_insert(self, state: DocState, p: int, token: int, position_id: int) -> None:
        """Grow every cached array by one row at sequence index p."""
        state.tokens = np.insert(state.tokens, p, token)
        state.positions = np.insert(state.positions, p, position_id)
        state.layers = [LayerState(*(_insert_row(getattr(st, f), p) for f in st.FIELDS))
                        for st in state.layers]
        state.xs = [_insert_row(x, p) for x in state.xs]

    def apply_insert(self, state: DocState, p: int, token: int, position_id: int) -> DocState:
        """Insert a token before sequence index p with a pre-allocated gapped
        position id (paper §3.3). Later rows gain one attended column and a
        renormalization; the new row is computed like a dirty row."""
        state = state.copy()
        self._renumber_insert(state, p, token, position_id)
        n = state.n
        counts = self._counts(n)
        dirty = np.array([p], np.int64)
        x_prev_rows = self._embed(state.tokens[p:p + 1], state.positions[p:p + 1])
        for li, W in enumerate(self.layers):
            st = state.layers[li]
            x_in = state.xs[li]
            dt = self._idx(dirty)
            # the inserted row itself (always dirty) + any propagated rows,
            # which need handling like replaces
            x_in[dt] = x_prev_rows
            q_new, k_new, v_new = self._qkv_at(W, x_prev_rows)
            vc_new = self._vc_of(W, v_new)
            repl_dirty = dirty[dirty != p]
            rt = self._idx(repl_dirty)
            old_k, old_vc = st.k[rt], st.vc[rt]
            st.q[dt], st.k[dt], st.v[dt], st.vc[dt] = q_new, k_new, v_new, vc_new

            later = np.setdiff1d(np.arange(p, n), dirty)
            if len(later) > 0:
                # new column at p (always present for rows > p)
                self._patch_one_column(st, later, p, +1.0)
                # replaced (propagated) columns among dirty rows
                if len(repl_dirty) > 0:
                    self._patch_columns(st, later, repl_dirty, st.k[rt], st.vc[rt],
                                        old_k, old_vc)
            st.T[dt] = self._row_scores(W, st.q[dt], st, dirty)
            # the count renormalization of rows >= p is in ``counts``
            affected = np.union1d(later, dirty) if len(later) else dirty
            changed = np.union1d(self._requantize(W, st, affected, counts), dirty)
            ch, x_prev_rows = self._propagate(W, st, x_in, changed)
            state.xs[li + 1][ch] = x_prev_rows
            dirty = changed
        return state

    def apply_delete(self, state: DocState, p: int) -> DocState:
        """Delete the token at sequence index p. Later rows lose one column
        (patch T by subtraction) and renormalize."""
        state = state.copy()
        n_old = state.n
        # subtract the deleted column's contribution from all later rows
        for st in state.layers:
            later = np.arange(p + 1, n_old)
            if len(later) > 0:
                self._patch_one_column(st, later, p, -1.0)
        # shrink every cached array
        state.tokens = np.delete(state.tokens, p)
        state.positions = np.delete(state.positions, p)
        state.layers = [LayerState(*(_delete_row(getattr(st, f), p) for f in st.FIELDS))
                        for st in state.layers]
        state.xs = [_delete_row(x, p) for x in state.xs]
        n = state.n
        counts = self._counts(n)

        # re-quantize rows >= p (count renormalization) and propagate
        dirty = np.zeros((0,), np.int64)
        x_prev_rows = torch.zeros((0, self.d), device=self.device)
        for li, W in enumerate(self.layers):
            st = state.layers[li]
            x_in = state.xs[li]
            dt = self._idx(dirty)
            old_k, old_vc = st.k[dt], st.vc[dt]
            x_in[dt] = x_prev_rows
            if len(dirty) > 0:
                q_new, k_new, v_new = self._qkv_at(W, x_prev_rows)
                vc_new = self._vc_of(W, v_new)
                st.q[dt], st.k[dt], st.v[dt], st.vc[dt] = q_new, k_new, v_new, vc_new
            later = np.setdiff1d(np.arange(p, n), dirty)
            if len(later) > 0 and len(dirty) > 0:
                self._patch_columns(st, later, dirty, st.k[dt], st.vc[dt], old_k, old_vc)
            if len(dirty) > 0:
                st.T[dt] = self._row_scores(W, st.q[dt], st, dirty)
            affected = np.union1d(later, dirty)
            if len(affected) == 0:
                continue
            changed = np.union1d(self._requantize(W, st, affected, counts),
                                 dirty).astype(np.int64)
            ch, x_prev_rows = self._propagate(W, st, x_in, changed)
            state.xs[li + 1][ch] = x_prev_rows
            dirty = changed
        return state

    def _revision_positions(self, state: DocState, n_new: int, kept_old: np.ndarray,
                            kept_new: np.ndarray) -> Optional[np.ndarray]:
        """Position ids of a revision: kept rows keep theirs, fresh runs get
        mid-gap ids; None when a gap cannot host its run."""
        new_positions = np.full(n_new, -1, np.int64)
        new_positions[kept_new] = state.positions[kept_old]
        pool = self.pos_emb.shape[0]
        i = 0
        while i < n_new:
            if new_positions[i] >= 0:
                i += 1
                continue
            run_start = i
            while i < n_new and new_positions[i] < 0:
                i += 1
            lo = new_positions[run_start - 1] if run_start > 0 else -1
            hi = new_positions[i] if i < n_new else pool
            run = i - run_start
            if hi - lo - 1 < run:
                return None
            for k in range(run):
                new_positions[run_start + k] = lo + (hi - lo) * (k + 1) // (run + 1)
            if len(set(new_positions[run_start:i])) != run:
                return None
        return new_positions

    def apply_revision(self, state: DocState, new_tokens: Sequence[int],
                       allocator=None, opcodes=None) -> DocState:
        """Offline batch path (paper §3 / App. A.1): align a whole revision
        against the cached document and process ALL structural changes in a
        single pass per layer — one column-patch sweep instead of one per
        edit. Falls back to a (counted) full forward when the positional
        gaps cannot host the inserted tokens. Pass precomputed
        ``core.edits.align(state.tokens, new_tokens)`` opcodes to reuse an
        alignment the caller already needed (e.g. for edit-count stats).
        """
        old_tokens = state.tokens
        new_tokens = np.asarray(list(new_tokens), np.int64)
        if opcodes is None:
            opcodes = align(old_tokens, new_tokens)
        kept_old, kept_new = [], []
        m0 = None  # first new index affected by any change
        for tag, i1, i2, j1, j2 in opcodes:
            if tag == "equal":
                kept_old.extend(range(i1, i2))
                kept_new.extend(range(j1, j2))
            elif m0 is None:
                m0 = j1
        if m0 is None:  # identical revision
            return state.copy()
        kept_old = np.asarray(kept_old, np.int64)
        kept_new = np.asarray(kept_new, np.int64)
        n_new = len(new_tokens)
        fresh = np.setdiff1d(np.arange(n_new), kept_new)
        removed_old = np.setdiff1d(np.arange(state.n), kept_old)

        new_positions = self._revision_positions(state, n_new, kept_old, kept_new)
        if new_positions is None:
            # defragment: every id changes -> full recompute (counted)
            if allocator is not None:
                allocator.positions = [0] * n_new
                allocator.defragment()
                pos = np.asarray(allocator.positions)
            else:
                pos = spread_positions(n_new, self.pos_emb.shape[0])
            return self.full_forward(new_tokens, pos)
        if allocator is not None:
            allocator.positions = [int(p) for p in new_positions]

        out = DocState(new_tokens.copy(), new_positions, [], [])
        counts = self._counts(n_new)
        ko, kn = self._idx(kept_old), self._idx(kept_new)
        value_dirty = fresh  # rows whose residual input changed (new indexing)
        x_dirty_rows = self._embed(new_tokens[fresh], new_positions[fresh])
        for li, W in enumerate(self.layers):
            old_st = state.layers[li]
            vd = self._idx(value_dirty)
            # structural copy of the residual-stream input
            x_in = torch.zeros((n_new, self.d), device=self.device)
            x_in[kn] = state.xs[li][ko]
            x_in[vd] = x_dirty_rows
            st = LayerState(*(getattr(old_st, f).new_zeros((n_new, *getattr(old_st, f).shape[1:]))
                              for f in LayerState.FIELDS))
            for f in LayerState.FIELDS:
                getattr(st, f)[kn] = getattr(old_st, f)[ko]
            # per-location updates at value-dirty rows
            q_new, k_new, v_new = self._qkv_at(W, x_in[vd])
            vc_new = self._vc_of(W, v_new)
            st.q[vd], st.k[vd], st.v[vd], st.vc[vd] = q_new, k_new, v_new, vc_new

            # ---- single column-patch sweep over stable kept rows ----
            stable = np.setdiff1d(kept_new[kept_new >= m0], value_dirty)
            if len(stable) > 0:
                sb = self._idx(stable)
                q_rows = st.q[sb]  # unchanged queries
                # (a) subtract columns that vanished or changed value:
                #     removed old columns + old values of value-dirty kept rows
                vdirty_kept_old = kept_old[np.isin(kept_new, value_dirty)]
                sub_old = np.concatenate([removed_old, vdirty_kept_old])
                if len(sub_old) > 0:
                    so = self._idx(sub_old)
                    stable_old = self._idx(kept_old[np.isin(kept_new, stable)])
                    self.counter.matmul("attn_col_scores", len(stable) * self.H,
                                        self.dh, len(sub_old))
                    self.counter.elementwise(
                        "attn_sigma", len(stable) * self.H * len(sub_old))
                    w_old = (self._scores(q_rows, old_st.k[so])
                             * (so[None, :] <= stable_old[:, None])[:, None, :])
                    self.counter.matmul("attn_col_patch", len(stable) * self.H,
                                        len(sub_old), self.Q)
                    st.T[sb] -= torch.einsum("mhj,jhq->mhq", w_old, old_st.vc[so])
                # (b) add new/changed columns (new indexing)
                add_new = np.union1d(fresh, value_dirty)
                if len(add_new) > 0:
                    an = self._idx(add_new)
                    self.counter.matmul("attn_col_scores", len(stable) * self.H,
                                        self.dh, len(add_new))
                    self.counter.elementwise(
                        "attn_sigma", len(stable) * self.H * len(add_new))
                    w_n = self._scores(q_rows, st.k[an]) * (an[None, :] <= sb[:, None])[:, None, :]
                    self.counter.matmul("attn_col_patch", len(stable) * self.H,
                                        len(add_new), self.Q)
                    st.T[sb] += torch.einsum("mhj,jhq->mhq", w_n, st.vc[an])
            # dirty rows: full recompute against the new arrays
            st.T[vd] = self._row_scores(W, st.q[vd], st, value_dirty)

            # re-quantize everything at/after the first edit (count renorm)
            affected = np.arange(m0, n_new)
            if len(affected) > 0:
                code_changed = self._requantize(W, st, affected, counts)
            else:
                code_changed = np.zeros((0,), np.int64)
            changed = np.union1d(code_changed, value_dirty).astype(np.int64)
            _, x_dirty_rows = self._propagate(W, st, x_in, changed)
            out.layers.append(st)
            out.xs.append(x_in)
            value_dirty = changed
        # final residual stream snapshot
        x_last = torch.zeros((n_new, self.d), device=self.device)
        x_last[kn] = state.xs[-1][ko]
        x_last[self._idx(value_dirty)] = x_dirty_rows
        out.xs.append(x_last)
        return out

    def apply_edit(self, state: DocState, e: Edit, allocator=None) -> DocState:
        """Apply one atomic edit. For inserts an id is taken from ``allocator``
        (PositionAllocator); if the gap is exhausted the engine defragments
        and re-runs a full forward (counted — paper §3.3)."""
        if e.op == "replace":
            return self.apply_replaces(state, [e.pos], [e.token])
        if e.op == "delete":
            if allocator is not None:
                allocator.delete_at(e.pos)
            return self.apply_delete(state, e.pos)
        # insert
        if allocator is None:
            # fabricate a mid-gap id (test paths)
            lo = state.positions[e.pos - 1] if e.pos > 0 else -1
            hi = state.positions[e.pos] if e.pos < state.n else self.pos_emb.shape[0]
            if hi - lo <= 1:
                raise ValueError("no positional gap; provide an allocator")
            pid = int((lo + hi) // 2)
        else:
            pid = allocator.insert_at(e.pos)
            if pid is None:
                # defragmentation: every position id changes -> full recompute
                # (counted; paper §3.3 "akin to defragmentation")
                allocator.positions.insert(e.pos, -1)  # placeholder, re-spread next
                new_positions = allocator.defragment()
                tokens = list(state.tokens)
                tokens.insert(e.pos, e.token)
                return self.full_forward(tokens, list(new_positions))
        return self.apply_insert(state, e.pos, e.token, pid)

    # ------------------------------------------------------------- outputs

    def logits_at(self, state: DocState, row: int = -1) -> torch.Tensor:
        """Next-token logits [vocab] after sequence row ``row`` (on the device)."""
        x = state.xs[-1][row]
        self.counter.elementwise("perloc_ln", self.d, 8)
        h = layernorm(x[None], self.fn_s, self.fn_b)[0]
        self.counter.matmul("head", 1, self.d, self.head_w.shape[1])
        return h @ self.head_w

    def hidden(self, state: DocState) -> torch.Tensor:
        return state.xs[-1]
