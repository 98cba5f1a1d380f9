"""Multi-document edit and suggestion serving over the batched engine — the
edit and suggestion paths of ``repro/serving/batch_server.py`` on PyTorch.

The scheduler is the reference's (read its module docstring): documents
live in slot buffers padded to capacity classes; clients submit replace /
insert / delete edits in sequence coordinates; ``step()`` peels each ready
document's longest same-op FIFO prefix (up to ``C`` edits) into a typed
bucket, groups documents by ``(n_cap, C, R, op)`` and serves each group
chunk with ONE ``batch_apply_edits`` dispatch (one ``fused_step`` kernel
launch per layer for the whole chunk). Structural slow paths: **grow**
(slot buffer full: ``pad_state`` on the device), **defrag** (position-id
gap exhausted: ``gather_slots`` + re-spread + ``full_forward``) and the
**overflow fallback** (a full forward, then the document's row capacity
``R`` doubles). A failed take or dispatch rolls every unserved document back
to its pre-take snapshot.

Clients may ``submit_suggest`` a standing suggestion subscription: after
every scheduling round each stale subscription is refreshed through
``serving.suggest.SuggestionEngine`` (KV export + re-prefill from the
earliest invalidated position). The ``invalid_from`` (since the last
refresh) and ``touched_from`` (since the last full forward) watermarks
record the earliest edited position id; a continuation that would run past
the position pool triggers a defrag and one retry.

Document state is a tiered, budgeted resource (``serving.state_store``):
with ``device_budget_bytes=`` the served documents may exceed device memory
— least-recently-touched documents evict to a host-RAM snapshot (warm) and,
past ``host_budget_bytes=``, to disk (cold, under ``spill_dir``), then
rehydrate bit-exactly on next touch (a re-upload, never a recompute).
``pin`` / ``unpin`` exempt documents from eviction; suggestion decode caches
count toward the budget as soft state. ``checkpoint_document``,
``export_document`` and ``import_document`` move a document between
servers (processes) bit-exactly: the snapshot carries the state, the
allocator ids, the host mirrors and the slot layout verbatim. The async
front end (``serving.async_server``) records per-request latencies in
``edit_latency`` / ``suggest_latency``.

With ``mesh=`` (a device list: ``launch.mesh.make_serving_mesh()``, or
entries that repeat, ``["cuda:0"] * 2``) every dispatch shards its document
axis over the mesh (``BatchedJitEngine``'s module docstring): batches pad to
a multiple of the mesh's k entries, and members are PLACED — each device
serves a contiguous block of rows, so the scheduler puts the heaviest edit
buckets on the lightest block (greedy LPT) and tracks the per-block
dirty-slot imbalance in ``stats.mean_shard_imbalance``. A document's state
rests on the device of the block that last wrote it; a dispatch that places
it on another device copies it there (``stats.state_moves``; a no-op when
the blocks share a card), and every single-document path (re-ingest, grow,
defrag, ``logits``, the suggestion's KV export) runs on the device where
the state rests. Rehydrated and imported states land on the primary device
``mesh[0]``, where the suggester's weights live. A one-entry mesh (or
``mesh=None``) is the single-device scheduler bit for bit.

``compilation_cache_dir`` (or ``$REPRO_COMPILE_CACHE_DIR``) points the
kernels' build cache at a directory that outlives the process
(``common.compile_cache``); off by default.

Host mirrors are copied to the device with ``torch.tensor`` (never
``torch.from_numpy``, which would share storage with a mirror the next take
mutates). The one host read per dispatch is the overflow vector.
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.store import (
    restore_serving_document, save_serving_document,
)
from repro_torch.common.bucketing import capacity_class, next_pow2
from repro_torch.common.compile_cache import enable_persistent_compilation_cache
from repro_torch.configs.base import ArchConfig
from repro_torch.core.edits import Edit
from repro_torch.core.positional import PositionAllocator
from repro_torch.serving.batch_engine import (
    BatchedJitEngine, stack_states, unstack_state,
)
from repro_torch.models.transformer import params_from_numpy
from repro_torch.serving.jit_engine import (
    OP_DELETE, OP_INSERT, OP_REPLACE, JitState, state_from_host,
    state_nbytes_for, state_to_host,
)
from repro_torch.serving.latency import LatencyStats
from repro_torch.serving.state_store import StateStore
from repro_torch.serving.suggest import (
    PositionHeadroomError, SuggestionEngine, SuggestStats,
)

_OPCODE = {"replace": OP_REPLACE, "insert": OP_INSERT, "delete": OP_DELETE}


@dataclass
class BatchStats:
    docs: int = 0
    edits_submitted: int = 0
    edits_applied: int = 0
    batch_steps: int = 0  # batched edit dispatches issued
    batched_docs: int = 0  # sum of dispatch group sizes
    overflows: int = 0
    full_forwards: int = 0  # ingests + overflow/defrag/grow re-ingests
    defrags: int = 0  # gap exhaustion -> position-id re-spread
    grows: int = 0  # slot buffer full -> capacity-class jump
    device_defrags: int = 0  # defrags served by gather_slots + full_forward
    device_grows: int = 0  # grows served by pad_state (no re-ingest)
    traced_shapes: int = 0  # distinct step shapes seen (ingest, edit, pad)
    suggest_refreshes: int = 0  # suggestion recomputes served
    suggest_invalidations: int = 0  # fresh suggestions staled by newer edits
    suggest_cached_hits: int = 0  # suggestions served from the cached
    # continuation without a prefill (the watermarks were unchanged)
    suggest_headroom_defrags: int = 0  # refreshes that ran out of position
    # ids past the document (PositionHeadroomError), defragged and retried
    # host time of each real refresh, ending at the continuation's host read
    refresh_latency: LatencyStats = field(default_factory=LatencyStats)
    # ---- latency SLOs: per-request admission-to-completion histograms,
    # recorded by the async front end (serving.async_server)
    edit_latency: LatencyStats = field(default_factory=LatencyStats)
    suggest_latency: LatencyStats = field(default_factory=LatencyStats)
    # ---- tiered state residency (serving.state_store): the byte and doc
    # counters are kept by the StateStore and reconcile exactly with a
    # recount of the underlying objects
    closes: int = 0  # close_document calls (docs stays = documents opened)
    bytes_hot: int = 0  # device-resident document states
    bytes_warm: int = 0  # host-RAM snapshots
    bytes_cold: int = 0  # on-disk spills
    bytes_suggest: int = 0  # device-resident suggestion decode caches (soft)
    docs_hot: int = 0
    docs_warm: int = 0
    docs_cold: int = 0
    evictions: int = 0  # hot -> warm demotions
    spills: int = 0  # warm -> cold demotions
    rehydrations: int = 0  # warm/cold -> hot re-uploads (bit-exact)
    rollback_rebuilds: int = 0  # void -> hot full-forward rebuilds (the
    # rollback corner: a mid-take re-ingest consumed the pre-take copy)
    state_touches: int = 0  # device-state reads routed through the store
    hot_hits: int = 0  # touches served without a rehydration or rebuild
    # ---- cross-process migration (fleet serving)
    exports: int = 0  # export_document calls
    imports: int = 0  # import_document calls
    # ---- per-device dispatch balance (serving over a mesh of k > 1)
    sharded_dispatches: int = 0  # dispatches issued over a mesh of k > 1
    shard_imbalance_sum: float = 0.0  # sum over dispatches of (max-min)/max load
    state_moves: int = 0  # member states copied to another device for a dispatch

    @property
    def mean_batch(self) -> float:
        return self.batched_docs / max(self.batch_steps, 1)

    @property
    def hot_hit_rate(self) -> float:
        """Fraction of device-state touches served from the hot tier; 1.0
        when the budget never forced a rehydration."""
        return self.hot_hits / max(self.state_touches, 1)

    @property
    def mean_shard_imbalance(self) -> float:
        """Mean per-dispatch dirty-slot imbalance across the mesh's blocks:
        0.0 = perfectly balanced, 1.0 = one block received all the work
        while another idled."""
        return self.shard_imbalance_sum / max(self.sharded_dispatches, 1)


@dataclass
class _BatchDoc:
    doc_id: str
    tokens: np.ndarray  # [n_cap] int32 slot buffer, host-side source of truth
    valid: np.ndarray  # [n_cap] bool
    positions: np.ndarray  # [n_cap] int32 (gapped ids; free slots: sentinel)
    slots: list  # sequence index -> slot (the host's order oracle)
    free: list  # free slot indices
    n_cap: int
    row_capacity: int  # per-document R; doubles on overflow
    allocator: PositionAllocator  # sequence-ordered gapped position ids
    state: Optional[JitState]  # device state at padded shape (None = evicted)
    state_epoch: int = 0  # bumped on every content-CHANGING state replacement
    # (dispatch adoption, re-ingest) but NOT on rehydration, which re-uploads
    # identical bits — the rollback path uses it to tell the two apart
    pending: deque = field(default_factory=deque)  # FIFO of (op, pos, tok)
    n_virtual: int = 0  # length after every queued edit applies
    # ---- suggestion serving
    suggestion: Optional[np.ndarray] = None  # last refreshed continuation
    suggest_n: int = 0  # standing request length (0 = no subscription)
    suggest_fresh: bool = False  # suggestion matches the current doc + queue
    suggest_serial: int = 0  # bumped per real refresh (NOT per cached hit)
    invalid_from: Optional[int] = None  # min pid edited since last refresh
    touched_from: Optional[int] = None  # min pid touched since last ingest

    @property
    def n(self) -> int:  # real length
        return len(self.slots)

    def seq_tokens(self) -> np.ndarray:
        return self.tokens[np.asarray(self.slots, np.int64)]

    def seq_positions(self) -> np.ndarray:
        return self.positions[np.asarray(self.slots, np.int64)]


class BatchServer:
    """Full-edit-algebra serving for many documents over one batched engine."""

    def __init__(self, params: dict, cfg: ArchConfig, *, edit_capacity: int = 8,
                 row_capacity: int = 64, max_batch: int = 8,
                 min_doc_capacity: int = 16, use_patch_kernel: bool = False,
                 use_fused_kernel: bool = True,
                 delta_threshold: float = 0.0, capacity_class_step: int = 4,
                 device_grow: bool = True, device_defrag: bool = True,
                 pos_pool: Optional[int] = None,
                 device_budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None, device=None, mesh=None,
                 compilation_cache_dir: Optional[str] = None):
        """``use_fused_kernel`` (default on, as in the reference) routes each
        layer's patch + requantize through one ``fused_step`` kernel launch;
        ``use_patch_kernel`` (with the fused kernel off) routes only the
        column patch through one ``incr_patch`` launch; ``delta_threshold`` is the served tolerance (0.0 serves bit-exactly
        like the ungated engine); ``capacity_class_step`` spaces the document
        capacity classes; ``device_grow`` / ``device_defrag`` serve the
        structural slow paths on the device instead of host re-ingests.
        ``device_budget_bytes`` / ``host_budget_bytes`` bound the hot and
        warm tiers of the state store (None: unbounded; accounting is always
        on) and ``spill_dir`` holds the cold tier (default: a fresh
        temporary directory on first spill). ``device`` defaults to
        ``"cuda"``; with ``mesh=`` (a sequence of devices) it defaults to,
        and must be, ``mesh[0]``, and ``max_batch`` must be a multiple of
        ``len(mesh)``. ``compilation_cache_dir`` (None still honours
        ``$REPRO_COMPILE_CACHE_DIR``) keeps the kernel builds there."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if capacity_class_step < 2:
            raise ValueError("capacity_class_step must be >= 2")
        self.compilation_cache_dir = enable_persistent_compilation_cache(
            compilation_cache_dir)
        self.cfg = cfg
        self.C = next_pow2(edit_capacity)
        self.R = next_pow2(row_capacity)
        self.max_batch = max_batch
        self.min_doc_capacity = next_pow2(min_doc_capacity)
        self.use_patch_kernel = use_patch_kernel
        self.use_fused_kernel = use_fused_kernel
        self.delta_threshold = float(delta_threshold)
        self.capacity_class_step = capacity_class_step
        self.device_grow = device_grow
        self.device_defrag = device_defrag
        self.pos_pool = pos_pool or (cfg.pos_pool if cfg.pos_pool else cfg.max_seq)
        base = BatchedJitEngine(params, cfg, edit_capacity=self.C,
                                row_capacity=self.R,
                                use_patch_kernel=use_patch_kernel,
                                use_fused_kernel=use_fused_kernel,
                                delta_threshold=self.delta_threshold,
                                device=device, mesh=mesh)
        if base.n_shards > max_batch:
            raise ValueError(
                f"serving mesh batch axis of {base.n_shards} exceeds "
                f"max_batch={max_batch} — every dispatch must give each "
                "device at least one document row")
        if max_batch % base.n_shards != 0:
            raise ValueError(
                f"max_batch={max_batch} is not a multiple of the serving "
                f"mesh's {base.n_shards}-way batch axis — a full chunk "
                "would pad past the max_batch cap")
        self.device = base.device  # the primary device
        self.mesh = base.mesh
        self.n_shards = base.n_shards
        self._weights = base.weights
        self._replicas = base.replicas
        self._engines: dict[tuple[int, int], BatchedJitEngine] = {
            (self.C, self.R): base}
        self._shapes_seen: set = set()
        self.docs: dict[str, _BatchDoc] = {}
        self.stats = BatchStats()
        self._params = params
        self._sugg: Optional[SuggestionEngine] = None
        # streaming hook: when set, every REAL suggestion refresh calls
        # ``on_suggest_token(doc_id, serial, token)`` per decoded token
        self.on_suggest_token = None
        # True while step() is inside its take/dispatch section: host mirrors
        # of a peeled document run AHEAD of its device state there, so
        # snapshots the store captures mid-round are flagged inconsistent
        # (fine for in-process rehydration, refused by import_document)
        self._in_round = False
        self.store = StateStore(
            docs=self.docs, stats=self.stats,
            drop_suggest=self._drop_suggest_cache, reingest=self._reingest,
            device_budget_bytes=device_budget_bytes,
            host_budget_bytes=host_budget_bytes, spill_dir=spill_dir,
            in_round=lambda: self._in_round, device=self.device)

    @property
    def suggester(self) -> SuggestionEngine:
        """The (lazily built) suggestion engine shared by every document; it
        holds its own copy of the weights on the serving device. Its decode
        caches report their bytes to the state store (soft state)."""
        if self._sugg is None:
            self._sugg = SuggestionEngine(
                params_from_numpy(self._params, device=self.device), self.cfg,
                on_cache_bytes=self.store.note_suggest_bytes)
        return self._sugg

    @property
    def suggest_stats(self) -> SuggestStats:
        return self.suggester.stats

    def _drop_suggest_cache(self, doc_id: str) -> None:
        """Release one document's suggestion decode cache (the store's
        soft-state reclamation hook; the suggester's listener reports the
        freed bytes back to the store)."""
        if self._sugg is not None:
            self._sugg.drop(doc_id)

    # ------------------------------------------------------------- engines

    def engine(self, edit_capacity: int, row_capacity: int) -> BatchedJitEngine:
        """The per-capacity-bucket engine (cached; shares the weight stacks)."""
        key = (edit_capacity, row_capacity)
        if key not in self._engines:
            self._engines[key] = BatchedJitEngine(
                {}, self.cfg, edit_capacity=edit_capacity,
                row_capacity=row_capacity,
                use_patch_kernel=self.use_patch_kernel,
                use_fused_kernel=self.use_fused_kernel,
                delta_threshold=self.delta_threshold, device=self.device,
                mesh=self.mesh, _weights=self._weights,
                _replicas=self._replicas)
        return self._engines[key]

    def _count_shape(self, shape: tuple) -> None:
        if shape not in self._shapes_seen:
            self._shapes_seen.add(shape)
            self.stats.traced_shapes += 1

    def padded_cap(self, n: int) -> int:
        """The capacity class serving an ``n``-slot document: the smallest
        ``min_doc_capacity * step^k >= n``."""
        return capacity_class(n, self.min_doc_capacity,
                              self.capacity_class_step)

    def _padded_batch(self, chunk_len: int) -> int:
        """Dispatch batch sizes are padded up to a power of two (capped at
        ``max_batch``), so each capacity bucket sees O(log max_batch)
        shapes, then rounded up to a multiple of the mesh's k blocks (each
        device takes a contiguous ``B_pad / k`` block of document rows)."""
        b = min(next_pow2(chunk_len), self.max_batch)
        n = self.n_shards
        b = max(b, n)
        return -(-b // n) * n

    def _place_rows(self, weights: list, B_pad: int) -> tuple[list, list]:
        """Balanced placement of dispatch members onto the padded batch rows.

        Each mesh block serves the contiguous row block
        ``[s*B_pad/n, (s+1)*B_pad/n)``, so WHERE a document lands decides
        which device does its dirty-slot work. Greedy longest-processing-time
        assignment: heaviest bucket first onto the lightest non-full block.
        Returns ``(rows, loads)``: ``rows[r]`` is the member index occupying
        padded row ``r`` (None = filler row carrying an empty edit bucket),
        ``loads[s]`` the per-block dirty-slot totals. With a single block
        the placement is the identity, the single-device dispatch layout."""
        n = self.n_shards
        if n == 1:
            rows = list(range(len(weights)))
            rows += [None] * (B_pad - len(weights))
            return rows, [sum(weights)]
        per = B_pad // n
        blocks: list[list] = [[] for _ in range(n)]
        loads = [0] * n
        order = sorted(range(len(weights)), key=lambda i: (-weights[i], i))
        for i in order:
            s = min((j for j in range(n) if len(blocks[j]) < per),
                    key=lambda j: (loads[j], len(blocks[j]), j))
            blocks[s].append(i)
            loads[s] += weights[i]
        rows = []
        for blk in blocks:
            rows.extend(blk)
            rows.extend([None] * (per - len(blk)))
        return rows, loads

    def _note_balance(self, loads: list) -> None:
        if self.n_shards > 1:
            self.stats.sharded_dispatches += 1
            hi = max(loads)
            self.stats.shard_imbalance_sum += (hi - min(loads)) / max(hi, 1)

    def _block_device(self, row: int, B_pad: int) -> torch.device:
        """The device of the block that serves padded row ``row``."""
        if self.n_shards == 1:
            return self.device
        return self.mesh[row // (B_pad // self.n_shards)]

    def _moved(self, state: JitState, device) -> JitState:
        """``state`` on ``device``: the state itself, or a copy when it rests
        on another device (counted in ``stats.state_moves``)."""
        if state.x.device == device:
            return state
        self.stats.state_moves += 1
        return JitState(*(leaf.to(device) for leaf in state))

    def _batch_rows(self, states: list, rows: list):
        """The dispatch's stacked input: one stack (single device), or one
        stack per block built on the block's own device. A filler row
        repeats member 0 (single device) or its block's first member; a
        block of filler rows only is zeros made on its device, so no state
        crosses devices for output that is dropped."""
        if self.n_shards == 1:
            return stack_states([states[i if i is not None else 0] for i in rows])
        per = len(rows) // self.n_shards
        out = []
        for s, dev in enumerate(self.mesh):
            blk = rows[s * per:(s + 1) * per]
            if blk[0] is None:  # members fill each block from its first row
                out.append(JitState(*(torch.zeros((per, *leaf.shape), dtype=leaf.dtype,
                                                  device=dev) for leaf in states[0])))
                continue
            out.append(stack_states([self._moved(states[blk[0] if i is None else i], dev)
                                     for i in blk]))
        return out

    def _unstack_row(self, batched, row: int, B_pad: int) -> JitState:
        """Padded row ``row``'s state out of a dispatch's result."""
        if self.n_shards == 1:
            return unstack_state(batched, row)
        per = B_pad // self.n_shards
        return unstack_state(batched[row // per], row % per)

    @property
    def _pos_sentinel(self) -> int:
        # Free slots point at the last pool embedding: always in-bounds for
        # the gather, >= every allocated id, and masked out by valid anyway.
        return self.pos_pool - 1

    def _to_device(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """An eager copy of a (possibly live) host mirror on ``device``
        (default: the primary device)."""
        return torch.tensor(arr, device=self.device if device is None else device)

    def _resting(self, doc: _BatchDoc) -> torch.device:
        """Where the document's state rests (the primary device when it has
        no device state)."""
        return self.device if doc.state is None else doc.state.x.device

    # ------------------------------------------------------------- documents

    def open_document(self, doc_id: str, tokens: Sequence[int]) -> None:
        self.open_documents({doc_id: tokens})

    def open_documents(self, items: dict) -> None:
        """Ingest a fleet at once: documents sharing a capacity class run
        through ONE ``batch_full_forward`` dispatch (chunked by max_batch)."""
        prepared = []
        for doc_id, tokens in items.items():
            if doc_id in self.docs:
                raise KeyError(f"document {doc_id!r} already open")
            n = len(tokens)
            if n < 1:
                raise ValueError("empty document")
            toks = np.asarray(tokens, np.int32)
            if not (0 <= toks.min() and toks.max() < self.cfg.vocab):
                raise ValueError(
                    f"document {doc_id!r} has tokens outside vocab of "
                    f"{self.cfg.vocab}")
            n_cap = self.padded_cap(n)
            alloc = PositionAllocator(n, self.pos_pool)
            padded = np.zeros(n_cap, np.int32)
            padded[:n] = toks
            valid = np.zeros(n_cap, bool)
            valid[:n] = True
            positions = np.full(n_cap, self._pos_sentinel, np.int32)
            positions[:n] = alloc.snapshot()
            prepared.append((doc_id, padded, valid, positions, n, n_cap, alloc))
        eng = self.engine(self.C, self.R)
        groups: dict[int, list] = {}
        for p in prepared:
            groups.setdefault(p[5], []).append(p)
        for n_cap, members in sorted(groups.items()):
            for lo in range(0, len(members), self.max_batch):
                chunk = members[lo:lo + self.max_batch]
                B_pad = self._padded_batch(len(chunk))
                self.store.admit(
                    len(chunk) * state_nbytes_for(n_cap, eng.L, eng.meta))
                # ingest work scales with real length: balance it per block;
                # filler rows repeat the first member, their output dropped
                rows, loads = self._place_rows([c[4] for c in chunk], B_pad)
                row_of = [chunk[i] if i is not None else chunk[0] for i in rows]
                bstate = eng.batch_full_forward(
                    self._to_device(np.stack([c[1] for c in row_of])),
                    self._to_device(np.stack([c[3] for c in row_of])),
                    self._to_device(np.stack([c[2] for c in row_of])))
                self._count_shape(("full", B_pad, n_cap))
                self._note_balance(loads)
                for b, i in enumerate(rows):
                    if i is None:
                        continue
                    doc_id, padded, valid, positions, n, n_cap, alloc = chunk[i]
                    doc = _BatchDoc(
                        doc_id=doc_id, tokens=padded, valid=valid,
                        positions=positions, slots=list(range(n)),
                        free=list(range(n_cap - 1, n - 1, -1)), n_cap=n_cap,
                        row_capacity=min(self.R, n_cap), allocator=alloc,
                        state=self._unstack_row(bstate, b, B_pad), n_virtual=n)
                    self.docs[doc_id] = doc
                    self.store.register(doc)
                    self.stats.docs += 1
                    self.stats.full_forwards += 1

    def close_document(self, doc_id: str) -> None:
        """End a session: release the document's slots, allocator, state in
        any tier, suggestion cache and queue (pending edits are discarded)."""
        doc = self.docs.pop(doc_id)  # KeyError for unknown ids
        self._drop_suggest_cache(doc_id)  # listener zeroes its byte account
        self.store.close(doc)
        doc.pending.clear()
        doc.suggestion = None
        self.stats.closes += 1

    def pin(self, doc_id: str) -> None:
        """Exempt a document from eviction (rehydrating it now if needed, so
        a pinned document is always dispatch-ready). Its suggestion decode
        cache stays evictable — soft state."""
        if doc_id not in self.docs:
            raise KeyError(doc_id)
        self.store.pin(doc_id)

    def unpin(self, doc_id: str) -> None:
        self.store.unpin(doc_id)

    def evict(self, doc_id: str, tier: str = "warm") -> str:
        """Force-demote a document's state to ``"warm"`` (host RAM) or
        ``"cold"`` (disk); its next touch rehydrates it bit-exactly.
        Returns the resulting tier."""
        return self.store.demote(self.docs[doc_id], tier)

    def tier(self, doc_id: str) -> str:
        """Residency tier of an open document: "hot", "warm", "cold" (or
        "void" after the rollback corner, until the next touch)."""
        if doc_id not in self.docs:
            raise KeyError(doc_id)
        return self.store.tier(doc_id)

    # ------------------------------------------------------------- submits

    def _check_tok(self, tok: int) -> None:
        if not 0 <= tok < self.cfg.vocab:
            raise ValueError(f"token {tok} outside vocab of {self.cfg.vocab}")

    def _stale(self, doc: _BatchDoc) -> None:
        """A newer edit for the document invalidates its suggestion."""
        if doc.suggest_fresh:
            doc.suggest_fresh = False
            self.stats.suggest_invalidations += 1

    def _touch(self, doc: _BatchDoc, pid: int) -> None:
        """Record an applied edit's position id in the invalidation
        watermarks. Causal masking confines every propagated (or
        threshold-suppressed) row to ids >= the earliest edited id, so the
        minimum over edited ids covers every possibly-changed row."""
        pid = int(pid)
        doc.invalid_from = (pid if doc.invalid_from is None
                            else min(doc.invalid_from, pid))
        doc.touched_from = (pid if doc.touched_from is None
                            else min(doc.touched_from, pid))

    def submit_replace(self, doc_id: str, pos: int, tok: int) -> None:
        doc = self.docs[doc_id]
        if not 0 <= pos < doc.n_virtual:
            raise IndexError(
                f"pos {pos} out of range for doc of length {doc.n_virtual}")
        self._check_tok(tok)
        doc.pending.append(("replace", int(pos), int(tok)))
        self._stale(doc)
        self.stats.edits_submitted += 1

    def submit_insert(self, doc_id: str, pos: int, tok: int) -> None:
        """Insert ``tok`` before sequence index ``pos`` (``pos == n``
        appends). Positions refer to the sequence after every previously
        queued edit applies, exactly like an edit script."""
        doc = self.docs[doc_id]
        if not 0 <= pos <= doc.n_virtual:
            raise IndexError(
                f"insert pos {pos} out of range for doc of length {doc.n_virtual}")
        self._check_tok(tok)
        doc.pending.append(("insert", int(pos), int(tok)))
        doc.n_virtual += 1
        self._stale(doc)
        self.stats.edits_submitted += 1

    def submit_delete(self, doc_id: str, pos: int) -> None:
        doc = self.docs[doc_id]
        if not 0 <= pos < doc.n_virtual:
            raise IndexError(
                f"delete pos {pos} out of range for doc of length {doc.n_virtual}")
        if doc.n_virtual <= 1:
            raise ValueError("cannot delete the last remaining token")
        doc.pending.append(("delete", int(pos), 0))
        doc.n_virtual -= 1
        self._stale(doc)
        self.stats.edits_submitted += 1

    def submit_edit(self, doc_id: str, e: Edit) -> None:
        """Submit a ``core.edits.Edit`` (op/pos/token) as queued traffic."""
        if e.op == "replace":
            self.submit_replace(doc_id, e.pos, e.token)
        elif e.op == "insert":
            self.submit_insert(doc_id, e.pos, e.token)
        else:
            self.submit_delete(doc_id, e.pos)

    def pending_count(self) -> int:
        return sum(len(d.pending) for d in self.docs.values())

    # ------------------------------------------------------- snapshot/rollback

    def _snapshot(self, doc: _BatchDoc) -> tuple:
        return (doc.tokens.copy(), doc.valid.copy(), doc.positions.copy(),
                list(doc.slots), list(doc.free), doc.n_cap, doc.row_capacity,
                doc.allocator.snapshot(), doc.state, doc.state_epoch,
                deque(doc.pending), doc.n_virtual, doc.invalid_from,
                doc.touched_from, doc.suggest_fresh)

    def _restore(self, doc: _BatchDoc, snap: tuple) -> None:
        (doc.tokens, doc.valid, doc.positions, doc.slots, doc.free, doc.n_cap,
         doc.row_capacity, alloc_ids, state, epoch, doc.pending,
         doc.n_virtual, doc.invalid_from, doc.touched_from,
         doc.suggest_fresh) = snap
        doc.allocator.restore(alloc_ids)
        # Residency-aware and never raising (the except path restores many
        # documents in a row). Three cases:
        # 1. epoch unchanged — the state's content was never replaced (at
        #    most evicted and/or rehydrated, both bit-preserving) and the
        #    store's accounting already matches wherever it lives now;
        # 2. a mid-take grow/defrag replaced the content, but the snapshot
        #    still references the exact pre-take state — re-adopt it;
        # 3. the document entered the take evicted (snapshot state None) and
        #    a mid-take re-ingest consumed its warm/cold copy — the restored
        #    mirrors are the only source of truth: mark it void, and the
        #    next touch rebuilds it with a full forward.
        if epoch == doc.state_epoch:
            pass
        elif state is not None:
            self.store.set_hot(doc, state)
        else:
            self.store.mark_void(doc)

    # ------------------------------------------------------------- scheduling

    def _take_bucket(self, doc: _BatchDoc):
        """Pop the longest same-op FIFO prefix (up to C) into a typed edit
        bucket, translating sequence coordinates to slots as each edit is
        peeled. Host mirrors are updated here; the device catches up at
        dispatch. Returns (op_kind, arrays, count)."""
        kind = doc.pending[0][0]
        slot_a = np.full(self.C, -1, np.int32)
        tok_a = np.zeros(self.C, np.int32)
        pos_a = np.zeros(self.C, np.int32)
        op_a = np.full(self.C, _OPCODE[kind], np.int32)
        i = 0
        if kind == "replace":
            # Same-slot conflicts stay queued for the next round; scanning
            # stops at the first structural op (replaces do not commute
            # across an insert/delete).
            taken: set[int] = set()
            kept: list = []
            while doc.pending and i < self.C:
                if doc.pending[0][0] != "replace":
                    break
                _, pos, tok = doc.pending.popleft()
                s = doc.slots[pos]
                if s in taken:
                    kept.append(("replace", pos, tok))
                    continue
                taken.add(s)
                slot_a[i] = s
                tok_a[i] = tok
                pos_a[i] = doc.positions[s]
                doc.tokens[s] = tok
                self._touch(doc, doc.positions[s])
                i += 1
            for item in reversed(kept):
                doc.pending.appendleft(item)
        elif kind == "insert":
            while doc.pending and i < self.C:
                if doc.pending[0][0] != "insert":
                    break
                _, pos, tok = doc.pending[0]
                need_grow = not doc.free
                need_defrag = not doc.allocator.can_insert_at(pos)
                if need_grow or need_defrag:
                    if i > 0:
                        break  # flush the partial bucket first
                    if need_grow:
                        self._grow(doc)
                    if need_defrag:
                        self._defrag(doc)
                    if not doc.allocator.can_insert_at(pos):
                        raise RuntimeError(
                            f"position pool of {doc.allocator.pool_size} cannot "
                            f"host a document of length {doc.n + 1}")
                doc.pending.popleft()
                pid = doc.allocator.insert_at(pos)
                s = doc.free.pop()
                doc.slots.insert(pos, s)
                doc.tokens[s] = tok
                doc.valid[s] = True
                doc.positions[s] = pid
                slot_a[i] = s
                tok_a[i] = tok
                pos_a[i] = pid
                self._touch(doc, pid)
                i += 1
        else:  # delete
            while doc.pending and i < self.C:
                if doc.pending[0][0] != "delete":
                    break
                _, pos, _tok = doc.pending.popleft()
                s = doc.slots.pop(pos)
                doc.allocator.delete_at(pos)
                doc.valid[s] = False
                pos_a[i] = doc.positions[s]
                slot_a[i] = s
                doc.free.append(s)  # earliest reuse is the NEXT dispatch
                self._touch(doc, doc.positions[s])
                i += 1
        return kind, (slot_a, tok_a, pos_a, op_a), i

    def step(self) -> int:
        """One scheduling round: edit dispatches, then stale suggestion
        refreshes. Returns the number of edits applied."""
        ready = [d for d in self.docs.values() if d.pending]
        if not ready:
            self._refresh_suggestions()
            return 0
        takes = []  # (doc, kind, arrays, count)
        undone: dict[int, tuple] = {}  # id(doc) -> (doc, snapshot)
        applied = 0
        self._in_round = True
        try:
            for d in ready:
                undone[id(d)] = (d, self._snapshot(d))
                kind, arrays, count = self._take_bucket(d)
                if count == 0:
                    self._restore(d, undone.pop(id(d))[1])
                    continue
                takes.append((d, kind, arrays, count))
            groups: dict[tuple, list] = {}
            for t in takes:
                groups.setdefault(
                    (t[0].n_cap, self.C, t[0].row_capacity, t[1]),
                    []).append(t)
            for (n_cap, C, R, kind), members in sorted(groups.items(),
                                                       key=lambda kv: kv[0]):
                for lo in range(0, len(members), self.max_batch):
                    chunk = members[lo:lo + self.max_batch]
                    applied += self._dispatch(chunk, n_cap, C, R, kind)
                    for t in chunk:
                        undone.pop(id(t[0]), None)
        except Exception:
            # a failed take or dispatch must not lose edits: every document
            # not yet served rolls back to its pre-take snapshot
            for d, snap in undone.values():
                self._restore(d, snap)
            raise
        finally:
            self._in_round = False
        self._refresh_suggestions()
        return applied

    def flush(self) -> int:
        """Drain every queue; returns total edits applied. Stale suggestion
        subscriptions are refreshed too, also when there were no edits."""
        total = 0
        while self.pending_count():
            total += self.step()
        self._refresh_suggestions()  # no-op when every subscription is fresh
        return total

    def _dispatch(self, chunk: list, n_cap: int, C: int, R: int,
                  kind: str) -> int:
        eng = self.engine(C, R)
        docs = [t[0] for t in chunk]
        buckets = [t[2] for t in chunk]
        counts = [t[3] for t in chunk]
        keep = frozenset(d.doc_id for d in docs)
        states = [self.store.ensure_hot(d, keep=keep) for d in docs]
        # pad to a pow2 batch (a multiple of the mesh's blocks) with filler
        # rows carrying empty edit buckets (all -1): no-op slices whose
        # output is discarded. Members are placed to balance dirty-slot work
        # across the per-device row blocks.
        B_pad = self._padded_batch(len(chunk))
        rows, loads = self._place_rows(counts, B_pad)
        empty = (np.full(C, -1, np.int32), np.zeros(C, np.int32),
                 np.zeros(C, np.int32), np.zeros(C, np.int32))
        row_buckets = [buckets[i] if i is not None else empty for i in rows]
        slot, tok, pos = (self._to_device(np.stack([b[i] for b in row_buckets]))
                          for i in range(3))
        batched = self._batch_rows(states, rows)
        if kind == "replace":
            new_state, overflow = eng.batch_apply_replaces(batched, slot, tok)
        elif kind == "insert":
            new_state, overflow = eng.batch_apply_inserts(batched, slot, tok, pos)
        else:
            new_state, overflow = eng.batch_apply_deletes(batched, slot)
        # the dispatch's one host read, after every block's work is issued
        overflow = overflow.cpu().numpy()
        self.stats.batch_steps += 1
        self.stats.batched_docs += len(chunk)
        # the op vector is data: all three kinds share one step shape
        self._count_shape(("edit", B_pad, n_cap, C, R))
        self._note_balance(loads)
        applied = 0
        for b, i in enumerate(rows):
            if i is None:
                continue
            doc = docs[i]
            applied += counts[i]
            self.stats.edits_applied += counts[i]
            if overflow[b]:
                self._fallback_full_forward(doc, self._block_device(b, B_pad))
            else:
                self.store.set_hot(doc, self._unstack_row(new_state, b, B_pad))
        return applied

    # ------------------------------------------------------------ slow paths

    def _reingest(self, doc: _BatchDoc, device=None) -> None:
        """Rebuild device state from the host mirrors (one full forward) on
        ``device`` (default: where the state rests)."""
        device = self._resting(doc) if device is None else device
        eng = self.engine(self.C, self.R).on(device)
        # admit the replacement up front (a grown buffer is bigger than the
        # one it replaces; an evicted document brings wholly new bytes)
        resident = (self.store.nbytes(doc.doc_id)
                    if self.store.tier(doc.doc_id) == "hot" else 0)
        self.store.admit(max(state_nbytes_for(doc.n_cap, eng.L, eng.meta)
                             - resident, 0),
                         keep=frozenset((doc.doc_id,)))
        state = eng.full_forward(self._to_device(doc.tokens, device),
                                 self._to_device(doc.positions, device),
                                 self._to_device(doc.valid, device))
        self.store.set_hot(doc, state)
        # a from-scratch full forward again: every exported column is
        # trustworthy for suggestion KV reuse
        doc.touched_from = None
        self.stats.full_forwards += 1
        self._count_shape(("full", doc.n_cap))

    def _fallback_full_forward(self, doc: _BatchDoc, device) -> None:
        """Overflow: discard the unreliable batched slice, recompute from the
        host mirrors on the dispatch block's ``device``, and double the
        document's row bucket."""
        self.stats.overflows += 1
        self._reingest(doc, device)
        if doc.row_capacity < doc.n_cap:
            doc.row_capacity = min(doc.row_capacity * 2, doc.n_cap)

    def _grow(self, doc: _BatchDoc) -> None:
        """Slot buffer full: step ``n_cap`` up to the next capacity class
        (slots keep their indices, new free slots appended). With
        ``device_grow`` the resident state is padded on the device — no
        full forward, and the incremental history survives, so
        ``touched_from`` is kept. The suggestion cache's shape is void."""
        old_cap, new_cap = doc.n_cap, self.padded_cap(doc.n_cap + 1)
        for name, fill in (("tokens", 0), ("valid", False),
                           ("positions", self._pos_sentinel)):
            arr = getattr(doc, name)
            grown = np.full(new_cap, fill, arr.dtype)
            grown[:old_cap] = arr
            setattr(doc, name, grown)
        doc.free.extend(range(new_cap - 1, old_cap - 1, -1))
        doc.n_cap = new_cap
        self.stats.grows += 1
        self._drop_suggest_cache(doc.doc_id)
        if not self.device_grow:
            self._reingest(doc)
            return
        eng = self.engine(self.C, self.R)
        state = self.store.ensure_hot(doc, keep=frozenset((doc.doc_id,)))
        self.store.admit(
            state_nbytes_for(new_cap, eng.L, eng.meta)
            - state_nbytes_for(old_cap, eng.L, eng.meta),
            keep=frozenset((doc.doc_id,)))
        self.store.set_hot(doc, eng.pad_state(state, new_cap,
                                              pos_fill=self._pos_sentinel))
        self.stats.device_grows += 1
        self._count_shape(("pad", old_cap, new_cap))

    def _defrag(self, doc: _BatchDoc) -> None:
        """Gap exhaustion: re-spread every position id evenly (paper §3.3).
        Every cached activation depends on its position embedding, so the
        full forward is unavoidable; with ``device_defrag`` the slot
        compaction before it runs on the device (``gather_slots``) and feeds
        the same ``full_forward`` a re-ingest would run."""
        self.stats.defrags += 1
        # every position id changes: nothing in the decode cache is reusable
        self._drop_suggest_cache(doc.doc_id)
        doc.invalid_from = 0
        self._stale(doc)
        if not self.device_defrag:
            doc.allocator.defragment()
            doc.positions[np.asarray(doc.slots, np.int64)] = \
                doc.allocator.snapshot()
            self._reingest(doc)
            return
        state = self.store.ensure_hot(doc, keep=frozenset((doc.doc_id,)))
        dev = state.x.device
        eng = self.engine(self.C, self.R).on(dev)
        n = doc.n
        # compaction permutation: live slots in sequence order, then the
        # free tail — slot i of the permuted buffers is token i
        order = np.concatenate([np.asarray(doc.slots, np.int32),
                                np.asarray(doc.free, np.int32)])
        doc.allocator.defragment()
        permuted = eng.gather_slots(state, self._to_device(order, dev))
        new_positions = np.full(doc.n_cap, self._pos_sentinel, np.int32)
        new_positions[:n] = doc.allocator.snapshot()
        new_valid = np.zeros(doc.n_cap, bool)
        new_valid[:n] = True
        self.store.set_hot(doc, eng.full_forward(
            permuted.tokens, self._to_device(new_positions, dev),
            self._to_device(new_valid, dev)))
        # host mirrors follow the compaction so slot indices keep matching
        doc.tokens = doc.tokens[order]
        doc.valid = new_valid
        doc.positions = new_positions
        doc.slots = list(range(n))
        doc.free = list(range(doc.n_cap - 1, n - 1, -1))
        doc.touched_from = None
        self.stats.device_defrags += 1
        self.stats.full_forwards += 1
        self._count_shape(("full", doc.n_cap))

    # ------------------------------------------------------------ suggestions

    def submit_suggest(self, doc_id: str, n_new: int = 8) -> None:
        """Open a standing suggestion subscription: after every scheduling
        round the document's greedy ``n_new``-token continuation is kept
        fresh. Cancel with ``cancel_suggest``."""
        doc = self.docs[doc_id]
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if doc.suggest_n != n_new:
            doc.suggest_n = int(n_new)
            doc.suggest_fresh = False

    def cancel_suggest(self, doc_id: str) -> None:
        doc = self.docs[doc_id]
        doc.suggest_n = 0
        doc.suggestion = None
        doc.suggest_fresh = False

    def suggestion(self, doc_id: str) -> Optional[np.ndarray]:
        """The last refreshed continuation, or None while it is stale."""
        doc = self.docs[doc_id]
        return doc.suggestion.copy() if doc.suggest_fresh else None

    def suggest(self, doc_id: str, n_new: int = 8) -> np.ndarray:
        """Flush the document's pending edits and return a fresh greedy
        continuation (subscribing the document if it was not already). When
        nothing changed since the last refresh and the cached continuation
        covers ``n_new``, it is returned without a prefill."""
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        doc = self.docs[doc_id]
        if (not doc.pending and doc.suggest_fresh and doc.invalid_from is None
                and doc.suggestion is not None
                and len(doc.suggestion) >= n_new):
            self.stats.suggest_cached_hits += 1
            return doc.suggestion[:n_new].copy()
        self.submit_suggest(doc_id, n_new)
        self.flush()
        if not doc.suggest_fresh:
            self._refresh_doc(doc)
        return doc.suggestion.copy()

    def _refresh_suggestions(self) -> None:
        """Serve stale subscriptions, grouped by capacity class. A document
        with queued edits stays stale until they apply."""
        ready = [d for d in self.docs.values()
                 if d.suggest_n > 0 and not d.suggest_fresh and not d.pending]
        for doc in sorted(ready, key=lambda d: (d.n_cap, d.doc_id)):
            self._refresh_doc(doc)

    def _refresh_doc(self, doc: _BatchDoc) -> None:
        # unchanged watermarks since the suggestion it holds: the greedy
        # continuation cannot differ — serve the cached tokens
        if (doc.invalid_from is None and doc.suggestion is not None
                and len(doc.suggestion) >= doc.suggest_n):
            doc.suggestion = doc.suggestion[:doc.suggest_n]
            doc.suggest_fresh = True
            self.stats.suggest_cached_hits += 1
            return
        sugg = self.suggester
        eng = self.engine(self.C, self.R)
        self.store.ensure_hot(doc)  # the KV export reads the device state
        on_token = None
        if self.on_suggest_token is not None:
            serial, hook = doc.suggest_serial + 1, self.on_suggest_token

            def on_token(tok, _id=doc.doc_id, _serial=serial, _hook=hook):
                _hook(_id, _serial, int(np.asarray(tok).reshape(-1)[0]))
        t0 = time.perf_counter()
        try:
            toks = sugg.refresh(
                eng.on(self._resting(doc)), doc.state, key=doc.doc_id,
                n_new=doc.suggest_n, invalid_from=doc.invalid_from,
                export_invalid_from=doc.touched_from, on_token=on_token)
        except PositionHeadroomError:
            # the tail gap is exhausted: re-spread the ids (a defrag and its
            # full forward) and retry once
            self.stats.suggest_headroom_defrags += 1
            self._defrag(doc)
            toks = sugg.refresh(
                eng.on(self._resting(doc)), doc.state, key=doc.doc_id,
                n_new=doc.suggest_n, invalid_from=doc.invalid_from,
                export_invalid_from=doc.touched_from, on_token=on_token)
        self.stats.refresh_latency.record((time.perf_counter() - t0) * 1e3)
        doc.suggestion = toks
        doc.suggest_fresh = True
        doc.invalid_from = None
        doc.suggest_serial += 1
        self.stats.suggest_refreshes += 1

    # ------------------------------------------------------------- outputs

    def _flushed(self, doc_id: str) -> _BatchDoc:
        doc = self.docs[doc_id]
        if doc.pending:
            raise RuntimeError(
                f"document {doc_id!r} has {len(doc.pending)} unflushed edits")
        return doc

    def tokens(self, doc_id: str) -> np.ndarray:
        """The document's tokens in sequence order."""
        return self._flushed(doc_id).seq_tokens().copy()

    def state(self, doc_id: str) -> JitState:
        return self.store.ensure_hot(self._flushed(doc_id))

    def logits(self, doc_id: str) -> np.ndarray:
        doc = self._flushed(doc_id)
        state = self.store.ensure_hot(doc)
        eng = self.engine(self.C, self.R).on(state.x.device)
        return eng.logits_at(state, doc.slots[-1]).cpu().numpy()

    # ------------------------------------------------------------- migration

    def checkpoint_document(self, doc_id: str, path: str) -> None:
        """Write a flushed document's full serving snapshot to ``path``
        (atomic) while keeping it open: the state, the allocator ids, the
        host mirrors and the slot layout with its free-list order, which
        bit-exact adoption must reproduce verbatim (attention reduces over
        the slot axis). A warm/cold document is rehydrated first, so it
        checkpoints the bits a hot one would."""
        doc = self._flushed(doc_id)
        # ensure_hot FIRST: it releases any cold holding, which may live at
        # this very path when the store shares a fleet's cold directory
        state = self.store.ensure_hot(doc)
        save_serving_document(
            path, state_to_host(state),
            allocator_ids=doc.allocator.snapshot(),
            mirrors={
                "tokens": doc.tokens.copy(),
                "valid": doc.valid.copy(),
                "positions": doc.positions.copy(),
                "slots": np.asarray(doc.slots, np.int32),
                "free": np.asarray(doc.free, np.int32),
            },
            meta={
                "doc_id": doc_id,
                "row_capacity": int(doc.row_capacity),
                "n_virtual": int(doc.n_virtual),
                "suggest_n": int(doc.suggest_n),
                "pos_pool": int(self.pos_pool),
                "invalid_from": doc.invalid_from,
                "touched_from": doc.touched_from,
                "consistent": True,  # flushed and out of round by construction
            })

    def export_document(self, doc_id: str, path: str) -> None:
        """Hand a document off for migration: checkpoint, then close. The
        snapshot at ``path`` survives the close, and a peer's
        ``import_document`` resumes the document bit-exactly."""
        self.checkpoint_document(doc_id, path)
        self.close_document(doc_id)
        self.stats.exports += 1

    def import_document(self, doc_id: str, path: str, *,
                        remove: bool = True) -> None:
        """Adopt a document from a serving snapshot (this package's or the
        reference's: the npz layout is shared) — the receiving half of
        migration and failover. A re-upload, never a recompute: slot buffer,
        free-list order, allocator ids and state are restored verbatim, so
        every later dispatch, logits read and suggestion refresh is
        bitwise-identical to a server that never moved the document on the
        same device. Snapshots marked ``consistent: False`` (captured
        mid-round by an eviction) are refused."""
        if doc_id in self.docs:
            raise KeyError(f"document {doc_id!r} already open")
        state_h, ids, mirrors, meta = restore_serving_document(path)
        if not meta.get("consistent", True):
            raise ValueError(
                f"snapshot for {doc_id!r} is marked inconsistent (captured "
                "mid-round); re-open the document from its tokens instead")
        if meta.get("doc_id") not in (None, doc_id):
            raise ValueError(
                f"snapshot at {path} belongs to {meta['doc_id']!r}, "
                f"not {doc_id!r}")
        pool = meta.get("pos_pool")
        if pool is not None and int(pool) != self.pos_pool:
            raise ValueError(
                f"snapshot position pool {pool} != server pool "
                f"{self.pos_pool} — position ids would not be comparable")
        tokens = np.array(mirrors["tokens"], np.int32, copy=True)
        n_cap = int(tokens.shape[0])
        eng = self.engine(self.C, self.R)
        self.store.admit(state_nbytes_for(n_cap, eng.L, eng.meta))
        alloc = PositionAllocator(1, self.pos_pool)
        alloc.restore([int(i) for i in np.asarray(ids)])
        doc = _BatchDoc(
            doc_id=doc_id, tokens=tokens,
            valid=np.array(mirrors["valid"], bool, copy=True),
            positions=np.array(mirrors["positions"], np.int32, copy=True),
            slots=[int(s) for s in mirrors["slots"]],
            free=[int(s) for s in mirrors["free"]],
            n_cap=n_cap, row_capacity=int(meta["row_capacity"]),
            allocator=alloc, state=state_from_host(state_h, self.device),
            n_virtual=int(meta.get("n_virtual", len(mirrors["slots"]))),
            suggest_n=int(meta.get("suggest_n", 0)),
            invalid_from=meta.get("invalid_from"),
            touched_from=meta.get("touched_from"))
        self.docs[doc_id] = doc
        self.store.register(doc)
        self.stats.docs += 1
        self.stats.imports += 1
        if remove:
            os.remove(path)
