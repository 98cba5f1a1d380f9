"""Suggestion decoding over an edited document's incremental state — the
port of ``repro/serving/suggest.py`` (the paper's writing-assistant loop:
keep a greedy continuation fresh while the document is edited). Read the
reference's module docstring for the design; in short:

1. ``JitIncrementalEngine.export_kv`` gathers the slot buffer's cached k/v
   into sequence order, a ready-made decode KV cache;
2. ``SuggestionEngine.refresh`` re-prefills only from the earliest
   invalidated position: rows before the earliest edited position id depend,
   by causal masking, only on other untouched rows, so their cache entries
   are reused verbatim (from the previous refresh's decode cache, else from
   the KV export). Rows at/after it run through
   ``models.transformer.prefill_step`` in ONE chunk, its length bucketed to
   a power of two;
3. the continuation is ``serving.decode`` greedy steps.

Contract: the suggestion equals the from-scratch decode oracle
(``oracle_suggestion``) token for token after every edit, and the reuse
counts in ``SuggestStats`` equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.common.bucketing import next_pow2
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving.decode import greedy_continue, make_serve_step
from repro_torch.serving.jit_engine import JitIncrementalEngine, JitState


class PositionHeadroomError(RuntimeError):
    """The continuation's position ids would run past the embedding pool —
    the caller must defragment (re-spread ids, which restores tail headroom)
    before refreshing the suggestion."""


@dataclass
class SuggestStats:
    refreshes: int = 0
    rebuilds: int = 0  # decode cache (re)built from the KV export
    prefill_rows_reused: int = 0  # rows served from cached prefix state
    prefill_rows_recomputed: int = 0  # real rows re-prefilled
    prefill_rows_launched: int = 0  # incl. bucket padding (fixed shapes)
    decode_steps: int = 0

    @property
    def prefill_rows_total(self) -> int:
        return self.prefill_rows_reused + self.prefill_rows_recomputed

    @property
    def reused_fraction(self) -> float:
        return self.prefill_rows_reused / max(self.prefill_rows_total, 1)


@dataclass
class _SuggestCache:
    """Per-document decode caches persisted across refreshes. Rows
    ``0..n-1`` of the cache tensors hold the document's sequence-ordered
    state as of the last refresh (suggestion rows beyond ``n`` are stale —
    the next refresh rewinds the length counter past them)."""

    caches: list
    tokens: np.ndarray  # [n] sequence-ordered, as of the last refresh
    positions: np.ndarray  # [n]
    n: int
    n_cap: int
    n_new_cap: int


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class SuggestionEngine:
    """Greedy continuation decoding with edited-prefix reuse.

    One instance serves many documents (pass a distinct ``key`` per
    document to persist its decode cache across refreshes). ``params`` is
    the reference-layout tensor tree on the serving device
    (``models.transformer.params_from_numpy``)."""

    def __init__(self, params: dict, cfg: ArchConfig, *, default_new: int = 8,
                 dtype=torch.float32, on_cache_bytes=None):
        if cfg.pos not in ("learned", "sampled"):
            raise ValueError("suggestion serving expects absolute position ids")
        self.params = params
        self.cfg = cfg
        self.default_new = int(default_new)
        self.dtype = dtype
        self.device = params["embed"]["tok"].device
        self._step = make_serve_step(cfg, sample=False)
        self._prefill = lambda p, c, t, pos: T.prefill_step(p, cfg, t, c, pos)
        self._cache: dict = {}
        # residency listener (the state store's byte accounting): called with
        # (key, nbytes) whenever a document's persisted decode cache is
        # stored or dropped — soft device state (re-prefillable)
        self._on_cache_bytes = on_cache_bytes
        self.stats = SuggestStats()

    # ------------------------------------------------------------- cache mgmt

    def cache_nbytes(self, key) -> int:
        """Device bytes held by a document's persisted decode cache (0 when
        none), length counters included."""
        entry = self._cache.get(key)
        if entry is None:
            return 0
        return sum(t.numel() * t.element_size() for t in _leaves(entry.caches))

    def cached_keys(self) -> list:
        """Keys with a persisted decode cache (leak tests, reconciliation)."""
        return list(self._cache)

    def _notify(self, key, nbytes: int) -> None:
        if self._on_cache_bytes is not None:
            self._on_cache_bytes(key, nbytes)

    def drop(self, key) -> None:
        """Forget a document's persisted decode cache (a defrag re-spreads
        every position id, so nothing in it is reusable; a grow changes its
        shape). The next refresh rebuilds from the KV export."""
        if self._cache.pop(key, None) is not None:
            self._notify(key, 0)

    def pos_headroom(self, last_pos: int) -> int:
        """How many continuation ids fit after ``last_pos``."""
        return int(self.params["embed"]["pos"].shape[0]) - 1 - int(last_pos)

    # ------------------------------------------------------------- refresh

    def refresh(self, engine: JitIncrementalEngine, state: JitState, *,
                key=None, n_new: Optional[int] = None,
                invalid_from: Optional[int] = None,
                export_invalid_from: Optional[int] = None,
                on_token=None) -> np.ndarray:
        """Recompute the greedy continuation of the document in ``state``.

        ``invalid_from`` — earliest *position id* edited since the last
        refresh of ``key`` (None = nothing changed); governs reuse of the
        persisted decode cache. ``export_invalid_from`` — earliest position
        id touched by incremental passes since the document's last full
        forward (None = the state IS a full forward); governs reuse when the
        cache is (re)built from the KV export. Rows before the boundary are
        reused; rows at/after it are re-prefilled through the decode path.
        ``on_token`` streams each decoded token. Returns the ``n_new`` greedy
        tokens."""
        n_new = self.default_new if n_new is None else int(n_new)
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        n_new_cap = next_pow2(n_new)
        n = int(state.n_real)
        if n < 1:
            raise ValueError("cannot suggest over an empty document")
        n_cap = int(state.tokens.shape[0])
        # Sequence order from the small host-side leaves; the heavy k/v
        # gather (export_kv) runs only when the decode cache is rebuilt. Same
        # sort key as export_kv (both stable), so the row order matches the
        # export's on the rebuild path — garbage tail included.
        host_valid = state.valid.cpu().numpy()
        host_positions = state.positions.cpu().numpy()
        order = np.argsort(np.where(host_valid, host_positions,
                                    np.iinfo(np.int32).max), kind="stable")
        seq_tokens = state.tokens.cpu().numpy()[order]
        seq_positions = host_positions[order]
        last_pos = int(seq_positions[n - 1])
        if self.pos_headroom(last_pos) < n_new:
            raise PositionHeadroomError(
                f"{n_new} continuation ids after position {last_pos} exceed "
                f"the embedding pool of {self.params['embed']['pos'].shape[0]}"
                " — defragment the document first")

        def boundary(watermark: Optional[int]) -> int:
            # first sequence row whose position id the edits may have
            # invalidated; the last row is always recomputed so the refresh
            # yields last-token logits
            if watermark is None:
                return n - 1
            return int(np.searchsorted(seq_positions[:n], watermark, "left"))

        entry = self._cache.get(key) if key is not None else None
        if entry is not None and (entry.n_cap != n_cap
                                  or entry.n_new_cap != n_new_cap):
            entry = None
        if entry is not None:
            p = min(boundary(invalid_from), n - 1)
            # the reused prefix must be the exact rows the cache encodes
            if not (np.array_equal(entry.positions[:p], seq_positions[:p])
                    and np.array_equal(entry.tokens[:p], seq_tokens[:p])):
                p = 0
            caches = entry.caches
        else:
            p = min(boundary(export_invalid_from), n - 1)
            # the export runs where the state rests; a state on another
            # mesh device sends only its k/v over to the suggester's
            exp = engine.export_kv(state)
            k, v = exp.k.to(self.device), exp.v.to(self.device)
            caches = T.caches_from_kv(
                self.cfg, k[:, None], v[:, None],
                torch.zeros((1,), dtype=torch.int32, device=self.device),
                seq_len=n_cap + n_new_cap, dtype=self.dtype)
            self.stats.rebuilds += 1

        # -------- re-prefill rows [p_eff, n) in one bucketed chunk. The
        # bucket extends the chunk *downward* (recomputing extra reusable
        # rows) so every launched row is a real cache slot; when even the
        # full document underfills its bucket, the chunk covers the whole
        # exported buffer — the garbage tail rows land beyond the final
        # length counter, where attention never sees them.
        M = next_pow2(n - p)
        p_eff = n - M
        if p_eff < 0:
            p_eff, M = 0, n_cap
        caches = T.set_cache_length(caches, p_eff)
        chunk_t = torch.tensor(seq_tokens[p_eff:p_eff + M], device=self.device)[None]
        chunk_p = torch.tensor(seq_positions[p_eff:p_eff + M], device=self.device)[None]
        logits, caches = self._prefill(self.params, caches, chunk_t, chunk_p)
        caches = T.set_cache_length(caches, n)
        last_logits = logits[:, n - 1 - p_eff]  # [1, vocab]

        # -------- greedy continuation on fresh tail position ids
        gen_pos = torch.tensor(last_pos + 1 + np.arange(n_new, dtype=np.int32),
                               device=self.device)[None]
        toks, caches = greedy_continue(self._step, self.params, caches,
                                       last_logits, gen_pos, on_token=on_token)
        out = toks[0].cpu().numpy().astype(np.int32)

        if key is not None:
            self._cache[key] = _SuggestCache(
                caches=caches, tokens=seq_tokens[:n].copy(),
                positions=seq_positions[:n].copy(), n=n, n_cap=n_cap,
                n_new_cap=n_new_cap)
            self._notify(key, self.cache_nbytes(key))
        self.stats.refreshes += 1
        self.stats.prefill_rows_reused += p_eff
        self.stats.prefill_rows_recomputed += n - p_eff
        self.stats.prefill_rows_launched += M
        self.stats.decode_steps += n_new - 1
        return out


def oracle_suggestion(params: dict, cfg: ArchConfig,
                      engine: JitIncrementalEngine, tokens, positions, valid,
                      n_new: int,
                      suggester: Optional[SuggestionEngine] = None) -> np.ndarray:
    """The from-scratch full-recompute decode oracle: ingest the padded slot
    buffers with a full forward, then decode the continuation with ZERO
    prefix reuse (``export_invalid_from=0`` re-prefills every row through the
    decode path). Pass a reusable ``suggester`` to share it across calls.
    The host arrays are copied before the ingest (callers pass live server
    mirrors)."""
    state = engine.full_forward(np.array(tokens, copy=True),
                                np.array(positions, copy=True),
                                np.array(valid, copy=True))
    s = suggester or SuggestionEngine(params, cfg)
    return s.refresh(engine, state, n_new=n_new, export_invalid_from=0)
