"""Incremental serving engine — the writing-assistant deployment of the
paper, the PyTorch port of ``repro/serving/engine.py``.

Wraps ``repro_torch.core.incremental.IncrementalEngine`` with:

* a per-document activation cache (the online setting keeps "a cache for the
  first input", paper §3);
* gapped position-id management with automatic defragmentation (§3.3) —
  defrags are *counted* as full forward passes;
* an offline batch path: align a new revision against the cached base with
  an edit script and apply it in one column-patch sweep per layer;
* op accounting per request, for the Table-2 / Fig-3/4 experiments.

This server is the *op-counting* single-worker deployment: one engine, one
document per request, dynamic shapes, activations on ``device`` (default
``"cuda"``). Use it to *measure* the paper's op claims; use
``batch_server.BatchServer`` to *serve traffic*.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.edits import Edit, align, edit_script
from repro_torch.core.incremental import DocState, IncrementalEngine
from repro_torch.core.opcount import OpCounter, dense_transformer_forward_ops
from repro_torch.core.positional import PositionAllocator


@dataclass
class ServerStats:
    requests: int = 0
    edits: int = 0
    defrags: int = 0
    incremental_ops: int = 0
    full_ops_equiv: int = 0  # what recompute-from-scratch would have cost

    @property
    def speedup(self) -> float:
        return self.full_ops_equiv / max(self.incremental_ops, 1)


@dataclass
class _Doc:
    state: DocState
    allocator: PositionAllocator


class IncrementalServer:
    def __init__(self, params: dict, cfg: ArchConfig, *, pos_pool: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg
        self.counter = OpCounter()
        self.engine = IncrementalEngine(params, cfg, self.counter, device=device)
        self.pos_pool = pos_pool or (cfg.pos_pool if cfg.pos_pool else cfg.max_seq * 100)
        self.docs: dict[str, _Doc] = {}
        self.stats = ServerStats()

    # ------------------------------------------------------------- helpers

    def _dense_ops(self, n: int) -> int:
        """Analytic from-scratch cost at the current length (the baseline an
        ordinary deployment would pay per request)."""
        c = self.cfg
        kinds = {l.ffn for l in c.layer_list()}
        return dense_transformer_forward_ops(
            n_layers=c.n_layers, d_model=c.d_model, n_heads=c.n_heads,
            n_kv_heads=c.n_kv_heads, d_ff=c.d_ff, vocab=c.vocab, seq_len=n,
            ffn_gated=kinds <= {"swiglu", "geglu"}, include_lm_head=False,
        )

    def _measured(self, fn, *args, **kwargs):
        before = self.counter.total
        out = fn(*args, **kwargs)
        return out, self.counter.total - before

    # ------------------------------------------------------------- API

    def open_document(self, doc_id: str, tokens: Sequence[int]) -> ServerStats:
        """Ingest a document from scratch (one full forward, cached)."""
        alloc = PositionAllocator(len(tokens), self.pos_pool)
        state, ops = self._measured(
            self.engine.full_forward, np.asarray(tokens), np.asarray(alloc.positions)
        )
        self.docs[doc_id] = _Doc(state, alloc)
        self.stats.requests += 1
        self.stats.incremental_ops += ops
        self.stats.full_ops_equiv += self._dense_ops(len(tokens))
        return self.stats

    def apply_edit(self, doc_id: str, edit: Edit) -> int:
        """Online path: one atomic edit. Returns the ops spent."""
        doc = self.docs[doc_id]
        defrags_before = doc.allocator.defrag_count
        new_state, ops = self._measured(self.engine.apply_edit, doc.state, edit, doc.allocator)
        doc.state = new_state
        self.stats.requests += 1
        self.stats.edits += 1
        self.stats.defrags += doc.allocator.defrag_count - defrags_before
        self.stats.incremental_ops += ops
        self.stats.full_ops_equiv += self._dense_ops(new_state.n)
        return ops

    def submit_revision(self, doc_id: str, new_tokens: Sequence[int]) -> int:
        """Offline path: align the revision against the cached base ONCE and
        share the alignment between the edit-count stats and the engine's
        batched revision algorithm (one column-patch sweep per layer)."""
        doc = self.docs[doc_id]
        opcodes = align(list(doc.state.tokens), list(new_tokens))
        script = edit_script(list(doc.state.tokens), list(new_tokens), opcodes=opcodes)
        before = self.counter.total
        doc.state = self.engine.apply_revision(doc.state, new_tokens,
                                               doc.allocator, opcodes=opcodes)
        ops = self.counter.total - before
        self.stats.requests += 1
        self.stats.edits += len(script)
        self.stats.incremental_ops += ops
        self.stats.full_ops_equiv += self._dense_ops(doc.state.n)
        return ops

    def logits(self, doc_id: str) -> np.ndarray:
        return self.engine.logits_at(self.docs[doc_id].state).cpu().numpy()

    def tokens(self, doc_id: str) -> np.ndarray:
        return self.docs[doc_id].state.tokens.copy()
