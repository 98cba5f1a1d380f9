"""Batched dirty-slot serving — the port of ``repro/serving/batch_engine.py``
without a mesh.

The reference vmaps the single-document engine; here the engine's steps are
already written over a leading document axis, so ``BatchedJitEngine`` only
exposes them: ``batch_full_forward`` ingests B slot buffers,
``batch_apply_edits`` applies up to C typed edits to each of B documents
(one ``fused_step`` launch per layer for the whole batch) and returns a
per-document ``overflow [B]``. All documents of a batch share the
capacities ``(n_cap, C, R)``; the batch server's buckets guarantee this.
With ``use_patch_kernel=True`` (fused kernel off) each layer's column patch
is one batched ``incr_patch`` launch. ``batch_export_kv`` is the KV export
of every document of a batch in one gather.
Slice b of every batched result equals the single-document engine run on
document b.
"""
from __future__ import annotations

import torch

from repro_torch.serving.jit_engine import (
    OP_DELETE, OP_INSERT, JitIncrementalEngine, JitState, KVExport, _ln,
    sequence_order,
)

# A JitState whose every leaf carries a leading [B] document axis.
BatchedJitState = JitState


def stack_states(states: list[JitState]) -> BatchedJitState:
    """Stack per-document states along a new leading batch axis (a copy)."""
    return JitState(*(torch.stack(leaves) for leaves in zip(*states)))


def unstack_state(batched: BatchedJitState, b: int) -> JitState:
    """Slice document ``b`` back out of a batched state. The slice is copied
    unless the batch holds one document, so a document never keeps a whole
    dispatch's buffers alive (and its byte count stays its own)."""
    if batched.tokens.shape[0] == 1:
        return JitState(*(leaf[0] for leaf in batched))
    return JitState(*(leaf[b].clone() for leaf in batched))


class BatchedJitEngine(JitIncrementalEngine):
    """One fixed-shape step over B documents. Same constructor as
    ``JitIncrementalEngine``."""

    def batch_full_forward(self, tokens, positions, valid=None) -> BatchedJitState:
        """tokens/positions: [B, n] int, valid: [B, n] bool (None = all
        real) -> stacked state, leaves [B, ...]."""
        return self._batch_full_forward(tokens, positions, valid)

    def batch_apply_edits(self, state: BatchedJitState, slot, tok, pos_id, op):
        """slot/tok/pos_id/op: [B, C] int (pad unused slots with -1).
        Returns (new_state, overflow [B] bool); an overflowed document's
        slice is UNRELIABLE and must be re-ingested."""
        return self._batch_apply_edits(
            state, *(self._tensor(a) for a in (slot, tok, pos_id, op)))

    def batch_apply_replaces(self, state, edit_pos, edit_tok):
        z = torch.zeros_like(self._tensor(edit_pos))
        return self.batch_apply_edits(state, edit_pos, edit_tok, z, z)

    def batch_apply_inserts(self, state, slot, tok, pos_id):
        slot = self._tensor(slot)
        op = torch.where(slot >= 0, OP_INSERT, 0)
        return self.batch_apply_edits(state, slot, tok, pos_id, op)

    def batch_apply_deletes(self, state, slot):
        slot = self._tensor(slot)
        z = torch.zeros_like(slot)
        op = torch.where(slot >= 0, OP_DELETE, 0)
        return self.batch_apply_edits(state, slot, z, z, op)

    def batch_export_kv(self, state: BatchedJitState) -> KVExport:
        """Position-ordered KV export of every document of the batch: each
        ``KVExport`` leaf gains a leading [B] axis (k, v: [B, L, n, H, dh]).
        Slice b equals ``export_kv`` of document b."""
        order = sequence_order(state.valid, state.positions)  # [B, n]
        b = torch.arange(order.shape[0], device=order.device)[:, None]
        take = lambda a: a[b[:, :, None], torch.arange(a.shape[1], device=a.device)[None, :, None],
                           order[:, None, :]]
        return KVExport(tokens=state.tokens[b, order], positions=state.positions[b, order],
                        order=order.to(torch.int32), k=take(state.k), v=take(state.v),
                        n_real=state.n_real)

    def batch_logits_at(self, state: BatchedJitState, index) -> torch.Tensor:
        """index: [B] per-document slot -> logits [B, vocab]."""
        index = self._tensor(index)
        x = state.x[:, -1][torch.arange(index.shape[0], device=self.device), index]
        return _ln(x, self.extras["fn_s"], self.extras["fn_b"]) @ self.extras["head_w"]
