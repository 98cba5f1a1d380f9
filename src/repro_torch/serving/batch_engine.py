"""Batched dirty-slot serving — the port of ``repro/serving/batch_engine.py``.

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

The serving mesh
----------------
``mesh=`` — a sequence of devices (``launch.mesh.make_serving_mesh()``, or
an explicit list whose entries may repeat: ``["cuda:0"] * 2``,
``["cpu"] * 4``) — shards the document axis of every batched entry point.
A batch of B rows splits into k = ``len(mesh)`` contiguous blocks of B/k
rows, and block s runs the ordinary batched step on ``mesh[s]`` (one
``fused_step`` launch per layer per block) with that device's weights. The
engine keeps one weight replica per *distinct* device, copied from the
base weights with ``.to``; repeated entries share it. No block reads
another's rows, so nothing crosses devices inside a step, and every
block's work is issued before anything reads the host, so blocks on
different cards overlap. B must divide by k (the batch server pads).

torch has no tensor that spans devices, so with k > 1 states go in and
come out as a list of k per-block states, block s on ``mesh[s]``; the
caller builds each block on its device. The small results are gathered on
the primary device ``mesh[0]`` (``overflow`` [B], logits [B, vocab]); KV
exports stay per block. ``mesh=None`` or a one-entry mesh runs the
single-device path bit for bit. The reference's ``batch_axis`` names an
axis of a JAX mesh; a list has one axis, so the port takes no such
argument.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
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


def mesh_device(device) -> torch.device:
    """``device`` resolved; a CUDA device always carries its index
    (``"cuda"`` is the current card), so two entries naming one card, and a
    tensor's own ``.device``, compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class BatchedJitEngine(JitIncrementalEngine):
    """One fixed-shape step over B documents, optionally over a mesh (see
    the module docstring). Same constructor as ``JitIncrementalEngine``,
    plus ``mesh``; with a mesh, ``device`` defaults to (and must be)
    ``mesh[0]``. ``_replicas`` ({device: (W, extras, meta)}) shares another
    engine's replicas."""

    def __init__(self, params, cfg, *, edit_capacity: int = 8,
                 row_capacity: int = 64, use_patch_kernel: bool = False,
                 use_fused_kernel: bool = False, delta_threshold: float = 0.0,
                 device=None, mesh=None, _weights=None, _replicas=None):
        if mesh is not None:
            mesh = [mesh_device(d) for d in mesh]
            if not mesh:
                raise ValueError("a serving mesh needs at least one device")
            if device is not None and mesh_device(device) != mesh[0]:
                raise ValueError(
                    f"device={device!r} is not the mesh's primary device {mesh[0]}")
            device = mesh[0]
        knobs = dict(edit_capacity=edit_capacity, row_capacity=row_capacity,
                     use_patch_kernel=use_patch_kernel,
                     use_fused_kernel=use_fused_kernel,
                     delta_threshold=delta_threshold)
        super().__init__(params, cfg, device="cuda" if device is None else device,
                         _weights=_weights, **knobs)
        self.mesh = mesh
        self.replicas = dict(_replicas or {})
        self.replicas.setdefault(self.device, self.weights)
        # the engine that runs a block (or a single document) on each device
        self._local = {self.device: self}
        for dev in mesh or ():
            if dev not in self._local:
                if dev not in self.replicas:
                    W, extras, meta = self.weights
                    self.replicas[dev] = ({k: v.to(dev) for k, v in W.items()},
                                          {k: v.to(dev) for k, v in extras.items()},
                                          meta)
                self._local[dev] = BatchedJitEngine(
                    {}, cfg, device=dev, _weights=self.replicas[dev], **knobs)

    @property
    def n_shards(self) -> int:
        """Blocks the document axis splits into (1 = single-device path)."""
        return len(self.mesh) if self.mesh is not None else 1

    def on(self, device) -> "BatchedJitEngine":
        """The engine for single-document work on a state resting on
        ``device``: this one, or the replica engine of another mesh device."""
        if self.n_shards == 1:
            return self
        return self._local[mesh_device(device)]

    # ------------------------------------------------------------ blocks

    def _check_batch(self, B: int) -> None:
        if B % self.n_shards != 0:
            raise ValueError(
                f"batch of {B} documents does not divide the serving mesh's "
                f"{self.n_shards}-way batch axis — pad the dispatch "
                "(BatchServer pads to a multiple automatically)")

    def _blocks(self, B: int) -> list:
        """(engine, rows) of each block of a B-row batch, in mesh order."""
        self._check_batch(B)
        per = B // self.n_shards
        return [(self._local[dev], slice(s * per, (s + 1) * per))
                for s, dev in enumerate(self.mesh)]

    def _check_states(self, states, B: int) -> None:
        """A mesh engine takes one state per block, each on its device."""
        if isinstance(states, JitState) or len(states) != self.n_shards:
            raise TypeError(f"a {self.n_shards}-block mesh engine takes a list "
                            f"of {self.n_shards} per-block states")
        for dev, st in zip(self.mesh, states):
            if st.x.device != dev or st.tokens.shape[0] * self.n_shards != B:
                raise ValueError(f"a block of {st.tokens.shape[0]} rows on "
                                 f"{st.x.device}, expected {B // self.n_shards} on {dev}")

    # ------------------------------------------------------------ batched API

    def batch_full_forward(self, tokens, positions, valid=None):
        """tokens/positions: [B, n] int, valid: [B, n] bool (None = all
        real) -> stacked state, leaves [B, ...] (with a mesh: a list of the
        k blocks' states)."""
        if self.n_shards == 1:
            return self._batch_full_forward(tokens, positions, valid)
        tokens, positions = self._tensor(tokens), self._tensor(positions)
        if valid is not None:
            valid = self._tensor(valid, torch.bool)
        return [eng._batch_full_forward(
                    tokens[r].to(eng.device), positions[r].to(eng.device),
                    None if valid is None else valid[r].to(eng.device))
                for eng, r in self._blocks(tokens.shape[0])]

    def batch_apply_edits(self, state, slot, tok, pos_id, op):
        """slot/tok/pos_id/op: [B, C] int (pad unused slots with -1).
        Returns (new_state, overflow [B] bool); an overflowed document's
        slice is UNRELIABLE and must be re-ingested. With a mesh ``state``
        and ``new_state`` are lists of the k blocks' states, and
        ``overflow`` lies on the primary device."""
        args = [self._tensor(a) for a in (slot, tok, pos_id, op)]
        if self.n_shards == 1:
            return self._batch_apply_edits(state, *args)
        B = args[0].shape[0]
        blocks = self._blocks(B)
        self._check_states(state, B)
        outs = [eng._batch_apply_edits(st, *(a[r].to(eng.device) for a in args))
                for (eng, r), st in zip(blocks, state)]
        return ([new for new, _ in outs],
                torch.cat([over.to(self.device) for _, over in outs]))

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

    def batch_export_kv(self, state):
        """Position-ordered KV export of every document of the batch: each
        ``KVExport`` leaf gains a leading [B] axis (k, v: [B, L, n, H, dh]).
        Slice b equals ``export_kv`` of document b. With a mesh: a list of
        the k blocks' exports, each on its block's device."""
        if self.n_shards == 1:
            return self._batch_export_kv(state)
        B = sum(st.tokens.shape[0] for st in state)
        self._check_batch(B)
        self._check_states(state, B)
        return [self._batch_export_kv(st) for st in state]

    @staticmethod
    def _batch_export_kv(state: BatchedJitState) -> KVExport:
        order = sequence_order(state.valid, state.positions)  # [B, n]
        b = torch.arange(order.shape[0], device=order.device)[:, None]
        take = lambda a: a[b[:, :, None], torch.arange(a.shape[1], device=a.device)[None, :, None],
                           order[:, None, :]]
        return KVExport(tokens=state.tokens[b, order], positions=state.positions[b, order],
                        order=order.to(torch.int32), k=take(state.k), v=take(state.v),
                        n_real=state.n_real)

    def batch_logits_at(self, state, index) -> torch.Tensor:
        """index: [B] per-document slot -> logits [B, vocab] (on the
        primary device with a mesh)."""
        index = self._tensor(index)
        if self.n_shards == 1:
            return self._batch_logits_at(state, index)
        blocks = self._blocks(index.shape[0])
        self._check_states(state, index.shape[0])
        return torch.cat([eng._batch_logits_at(st, index[r].to(eng.device)).to(self.device)
                          for (eng, r), st in zip(blocks, state)])

    def _batch_logits_at(self, state: BatchedJitState, index) -> torch.Tensor:
        x = state.x[:, -1][torch.arange(index.shape[0], device=self.device), index]
        return _ln(x, self.extras["fn_s"], self.extras["fn_b"]) @ self.extras["head_w"]
