"""Tiered document-state store — the PyTorch port of
``repro/serving/state_store.py`` (read its module docstring for the design).

Every open document's ``JitState`` lives in exactly one tier:

* **hot** — device-resident (CUDA tensors on the card). The only tier a
  dispatch, KV export or logits read can serve from.
* **warm** — a host-RAM numpy snapshot (``jit_engine.state_to_host``, an
  eager copy: no leaf shares storage with a device buffer, so dropping the
  device state really frees its memory).
* **cold** — an npz on disk (``checkpoint.save_serving_document``: the full
  ``JitState``, the allocator ids, the suggestion watermarks and the
  server's host mirrors and slot layout, all captured at eviction time).
  Writes are atomic and file names deterministic per document
  (``cold_path_for``), which is what lets a fleet share one cold directory.

Rehydration is a pure re-upload — bit-exact, never a recompute. Budget
policy (``admit``): a device budget in bytes covers resident document
states (``bytes_hot``) plus suggestion decode caches (``bytes_suggest``).
Over it, the store reclaims in LRU order, cheapest casualty first:

1. drop suggestion decode caches of non-protected documents (soft state: a
   dropped cache re-prefills from the KV export on the next refresh, with
   token-identical suggestions), even for pinned documents;
2. demote unpinned, non-protected hot documents to warm;
3. drop the protected documents' own suggestion caches;
4. raise ``DeviceBudgetError`` — only pins and the active dispatch's keep
   set can force this.

A host budget bounds the warm tier the same way: overflowing warm snapshots
spill to disk (LRU). Dispatch-transient copies (the stacked batch) are
outside the budget. The store keeps the server's ``BatchStats`` byte, doc
and movement counters; they reconcile exactly with a recount of the
underlying objects (``tests/test_torch_state_store.py``).

What differs from the reference: the store uploads to the server's
``device`` (``state_from_host`` takes one), and nothing it keeps after an
eviction — the warm snapshot, the mirrors, the entry — holds a CUDA
tensor, so ``torch.cuda.memory_allocated()`` falls by the evicted bytes
once the server drops its own references.
"""
from __future__ import annotations

import hashlib
import os
import re
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.store import (
    restore_document_state, save_serving_document,
)
from repro_torch.serving.jit_engine import (
    JitState, state_from_host, state_nbytes, state_to_host,
)


def cold_path_for(cold_dir: str, doc_id: str) -> str:
    """Deterministic per-document spill path — the cross-process contract of
    the shared cold tier (DESIGN.md §11): every replica pointed at the same
    directory computes the same file name for a document, so migration and
    failover can find each other's spills without a catalog. The sanitized
    id keeps names debuggable; the hash disambiguates ids that sanitize
    identically."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", doc_id)[:80]
    digest = hashlib.sha1(doc_id.encode()).hexdigest()[:8]
    return os.path.join(cold_dir, f"{safe}-{digest}.state.npz")

TIER_HOT = "hot"
TIER_WARM = "warm"
TIER_COLD = "cold"
# Not a storage tier: NO copy exists anywhere and the document must be
# rebuilt from its host mirrors (a full forward) on next touch. Only the
# dispatch-failure rollback corner produces this — a doc that entered a
# take evicted and whose warm/cold copy a mid-take re-ingest consumed —
# so rollback itself never computes (and never raises); the rebuild runs
# at ordinary touch time through the server's re-ingest callback.
TIER_VOID = "void"


class DeviceBudgetError(RuntimeError):
    """The device budget cannot admit the requested bytes: everything
    evictable has been evicted and what remains is pinned or belongs to the
    dispatch being served. Raise the budget, unpin documents, or lower
    ``max_batch`` (a dispatch needs its whole chunk hot at once)."""


@dataclass
class _Entry:
    doc_id: str
    nbytes: int  # state footprint (identical across tiers)
    tier: str = TIER_HOT
    lru: int = 0  # last-touch tick (monotonic store clock)
    pinned: bool = False
    suggest_bytes: int = 0  # device-resident decode cache (soft state)
    warm: Optional[JitState] = None  # host snapshot (warm tier payload)
    # (allocator ids, invalid_from, touched_from) captured at EVICTION time,
    # i.e. the same instant as the state snapshot — a later spill writes
    # these, not the live doc's (whose host mirrors may already be mid-take),
    # so the npz is internally consistent with its state payload
    warm_meta: Optional[tuple] = None
    # full host-mirror snapshot (tokens/valid/positions/slots/free + scalar
    # meta) captured at the same eviction instant — what a spill writes so
    # ANOTHER process can adopt the file as a complete serving document
    # (fleet failover, DESIGN.md §11). In-process rehydration ignores it.
    warm_mirrors: Optional[dict] = None
    cold_path: Optional[str] = None  # npz path (cold tier payload)
    cold_ids: Optional[np.ndarray] = None  # allocator ids recorded at spill


class StateStore:
    """Residency manager for ``BatchServer`` documents.

    ``docs`` is the server's live ``doc_id -> _BatchDoc`` dict (the store
    reads/writes ``doc.state`` through it); ``stats`` the server's
    ``BatchStats`` (authoritative byte/doc/eviction counters);
    ``drop_suggest`` a callback that drops one document's suggestion decode
    cache (the suggester's listener reports the freed bytes back through
    ``note_suggest_bytes``).
    """

    def __init__(self, *, docs: dict, stats, drop_suggest, reingest=None,
                 device_budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 in_round: Optional[Callable[[], bool]] = None,
                 device="cpu"):
        if device_budget_bytes is not None and device_budget_bytes <= 0:
            raise ValueError("device_budget_bytes must be positive (or None)")
        if host_budget_bytes is not None and host_budget_bytes <= 0:
            raise ValueError("host_budget_bytes must be positive (or None)")
        self.device_budget_bytes = device_budget_bytes
        self.host_budget_bytes = host_budget_bytes
        # spill_dir doubles as the SHARED cold tier when a fleet points every
        # replica's store at one directory (DESIGN.md §11): per-document file
        # names are deterministic (cold_path_for) and writes are atomic, so
        # peers can adopt spills; ownership is arbitrated by the fleet's
        # lease protocol, not by this class.
        self._spill_dir = spill_dir
        self._docs = docs
        self._stats = stats
        self._drop_suggest = drop_suggest
        self._reingest = reingest  # rebuild-from-mirrors (TIER_VOID recovery)
        # truthy while the server is inside a scheduling round: host mirrors
        # of a mid-take document run AHEAD of its device state, so snapshots
        # captured then are marked consistent=False (usable for in-process
        # rehydration, not for cross-process adoption)
        self._in_round = in_round
        self._device = device  # where rehydration re-uploads
        self._entries: dict[str, _Entry] = {}
        self._clock = 0

    # ------------------------------------------------------------- queries

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._entries

    def tier(self, doc_id: str) -> str:
        return self._entries[doc_id].tier

    def tiers(self) -> dict[str, str]:
        """doc_id -> tier, for every managed document (test introspection)."""
        return {d: e.tier for d, e in self._entries.items()}

    def nbytes(self, doc_id: str) -> int:
        return self._entries[doc_id].nbytes

    def pinned(self, doc_id: str) -> bool:
        return self._entries[doc_id].pinned

    # ------------------------------------------------------------- plumbing

    def _tick(self, e: _Entry) -> None:
        self._clock += 1
        e.lru = self._clock

    def _budget_used(self) -> int:
        return self._stats.bytes_hot + self._stats.bytes_suggest

    def _spill_path(self, doc_id: str) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="repro-torch-state-store-")
        os.makedirs(self._spill_dir, exist_ok=True)
        return cold_path_for(self._spill_dir, doc_id)

    def _drop_holdings(self, e: _Entry) -> None:
        """Forget whatever tier payload the entry holds (accounting too).
        TIER_VOID holds nothing."""
        if e.tier == TIER_HOT:
            self._stats.bytes_hot -= e.nbytes
            self._stats.docs_hot -= 1
        elif e.tier == TIER_WARM:
            self._stats.bytes_warm -= e.nbytes
            self._stats.docs_warm -= 1
            e.warm = None
            e.warm_meta = None
            e.warm_mirrors = None
        elif e.tier == TIER_COLD:
            self._stats.bytes_cold -= e.nbytes
            self._stats.docs_cold -= 1
            if e.cold_path and os.path.exists(e.cold_path):
                os.remove(e.cold_path)
            e.cold_path = None
            e.cold_ids = None

    # ------------------------------------------------------------- lifecycle

    def register(self, doc) -> None:
        """Adopt a freshly ingested document (its ``state`` is hot)."""
        if doc.doc_id in self._entries:
            raise KeyError(f"document {doc.doc_id!r} already in the store")
        e = _Entry(doc_id=doc.doc_id, nbytes=state_nbytes(doc.state))
        self._entries[doc.doc_id] = e
        self._stats.bytes_hot += e.nbytes
        self._stats.docs_hot += 1
        self._tick(e)

    def set_hot(self, doc, state: JitState) -> None:
        """Adopt a REPLACED device state (dispatch result, re-ingest, grow).
        Discards any warm/cold copy — they describe the superseded state —
        and bumps the doc's ``state_epoch`` so the rollback path can tell a
        content-changing replacement from a content-preserving rehydration."""
        e = self._entries[doc.doc_id]
        self._drop_holdings(e)
        e.nbytes = state_nbytes(state)
        e.tier = TIER_HOT
        doc.state = state
        doc.state_epoch += 1
        self._stats.bytes_hot += e.nbytes
        self._stats.docs_hot += 1
        self._tick(e)

    def close(self, doc) -> None:
        """Release every holding of a closing document (any tier)."""
        e = self._entries.pop(doc.doc_id)
        self._drop_holdings(e)
        self._stats.bytes_suggest -= e.suggest_bytes
        doc.state = None

    def pin(self, doc_id: str) -> None:
        """Exempt the document from eviction (and make it hot now, so a
        pinned doc is always dispatch-ready). Suggestion decode caches stay
        evictable even when pinned — they are soft state."""
        self.ensure_hot(self._docs[doc_id])
        self._entries[doc_id].pinned = True

    def unpin(self, doc_id: str) -> None:
        self._entries[doc_id].pinned = False

    # ------------------------------------------------------------- admission

    def admit(self, nbytes: int, keep: frozenset = frozenset()) -> None:
        """Make room for ``nbytes`` of incoming device state. ``keep`` names
        documents that must stay hot (the dispatch chunk being assembled)."""
        if self.device_budget_bytes is None:
            return

        def over() -> bool:
            return self._budget_used() + nbytes > self.device_budget_bytes

        if not over():
            return
        by_lru = sorted(self._entries.values(), key=lambda e: e.lru)
        # 1. soft state first: non-protected suggestion decode caches
        for e in by_lru:
            if not over():
                return
            if e.suggest_bytes and e.doc_id not in keep:
                self._drop_suggest(e.doc_id)
        # 2. LRU-with-pinning: demote hot documents to warm
        for e in by_lru:
            if not over():
                return
            if e.tier == TIER_HOT and not e.pinned and e.doc_id not in keep:
                self._evict_hot(e)
        # 3. last resort: the protected documents' own decode caches
        for e in by_lru:
            if not over():
                return
            if e.suggest_bytes:
                self._drop_suggest(e.doc_id)
        if over():
            pinned = sum(e.nbytes for e in self._entries.values() if e.pinned)
            kept = sum(e.nbytes for e in self._entries.values()
                       if e.doc_id in keep and e.tier == TIER_HOT)
            raise DeviceBudgetError(
                f"cannot admit {nbytes} bytes under a device budget of "
                f"{self.device_budget_bytes}: {self._stats.bytes_hot} hot "
                f"({pinned} pinned, {kept} held by the active dispatch) + "
                f"{self._stats.bytes_suggest} suggestion-cache bytes remain")

    def note_suggest_bytes(self, doc_id: str, nbytes: int) -> None:
        """Suggestion decode-cache accounting (the suggester's listener).
        Growth may push the budget over — reclaim immediately, protecting
        the document whose refresh just produced the cache."""
        e = self._entries.get(doc_id)
        if e is None:
            return  # unmanaged key (oracle harnesses)
        delta = int(nbytes) - e.suggest_bytes
        e.suggest_bytes = int(nbytes)
        self._stats.bytes_suggest += delta
        if delta > 0:
            self.admit(0, keep=frozenset((doc_id,)))

    # ------------------------------------------------------------- movement

    def ensure_hot(self, doc, keep: frozenset = frozenset()) -> JitState:
        """The transparent-rehydration entry point: every device-state read
        (dispatch stacking, KV export, logits, re-ingest bases) goes through
        here — it is also the LRU clock. Hot documents just touch the
        clock; warm/cold documents re-upload their snapshot — bit-exact, no
        recompute; a void document (rollback corner) rebuilds from its host
        mirrors through the server's re-ingest callback."""
        e = self._entries[doc.doc_id]
        self._tick(e)
        self._stats.state_touches += 1
        if e.tier == TIER_HOT:
            self._stats.hot_hits += 1
            return doc.state
        if e.tier == TIER_VOID:
            self._reingest(doc)  # admits, recomputes, adopts via set_hot
            self._stats.rollback_rebuilds += 1
            return doc.state
        self.admit(e.nbytes, keep=keep | frozenset((doc.doc_id,)))
        if e.tier == TIER_COLD:
            host_state, ids, _meta = restore_document_state(e.cold_path)
            if e.cold_ids is not None and not np.array_equal(
                    np.asarray(ids), e.cold_ids):
                raise RuntimeError(
                    f"cold-tier corruption for {doc.doc_id!r}: allocator ids "
                    "in the spill file do not match the ids recorded at "
                    "spill time")
        else:
            host_state = e.warm
        self._drop_holdings(e)  # releases the snapshot / spill file + bytes
        # content-preserving re-upload: doc.state_epoch does NOT bump
        doc.state = state_from_host(host_state, self._device)
        e.tier = TIER_HOT
        self._stats.bytes_hot += e.nbytes
        self._stats.docs_hot += 1
        self._stats.rehydrations += 1
        return doc.state

    def mark_void(self, doc) -> None:
        """Rollback corner: the document's pre-take copy no longer exists in
        any tier (a mid-take re-ingest consumed it) and the host mirrors are
        the only source of truth. Never computes — the rebuild happens at
        the next touch (``ensure_hot``), where admission and a full forward
        can fail at ordinary, recoverable times."""
        e = self._entries[doc.doc_id]
        self._drop_holdings(e)
        e.tier = TIER_VOID
        doc.state = None

    def demote(self, doc, tier: str) -> str:
        """Force-evict a document to ``tier`` (tests, benchmarks, and the
        admission passes). No-op if the document is already at or below the
        target tier. Returns the resulting tier."""
        if tier not in (TIER_WARM, TIER_COLD):
            raise ValueError(f"cannot demote to tier {tier!r}")
        e = self._entries[doc.doc_id]
        if e.pinned:
            raise ValueError(f"document {doc.doc_id!r} is pinned")
        if e.tier == TIER_HOT:
            self._evict_hot(e)
        if tier == TIER_COLD and e.tier == TIER_WARM:
            self._spill_warm(e)
        return e.tier

    # ------------------------------------------------------------- internals

    def _evict_hot(self, e: _Entry) -> None:
        doc = self._docs[e.doc_id]
        e.warm = state_to_host(doc.state)
        e.warm_meta = (doc.allocator.snapshot(), doc.invalid_from,
                       doc.touched_from)
        # full serving snapshot for cross-process adoption (only spills read
        # it). Mirrors are copied NOW, same instant as the state snapshot;
        # consistent=False when captured mid-round (a peeled take means the
        # mirrors run ahead of the state — fine for in-process rehydration,
        # poison for adoption).
        e.warm_mirrors = {
            "mirrors": {
                "tokens": doc.tokens.copy(),
                "valid": doc.valid.copy(),
                "positions": doc.positions.copy(),
                "slots": np.asarray(doc.slots, np.int32),
                "free": np.asarray(doc.free, np.int32),
            },
            "meta": {
                "doc_id": doc.doc_id,
                "row_capacity": int(doc.row_capacity),
                "n_virtual": int(doc.n_virtual),
                "suggest_n": int(doc.suggest_n),
                "pos_pool": int(doc.allocator.pool_size),
                "consistent": not (self._in_round is not None
                                   and self._in_round()),
            },
        }
        doc.state = None
        e.tier = TIER_WARM
        self._stats.bytes_hot -= e.nbytes
        self._stats.docs_hot -= 1
        self._stats.bytes_warm += e.nbytes
        self._stats.docs_warm += 1
        self._stats.evictions += 1
        if e.suggest_bytes:
            # the decode cache references this state's export lineage; it is
            # device memory with no document on device — always drop it
            self._drop_suggest(e.doc_id)
        self._spill_over_host_budget()

    def _spill_over_host_budget(self) -> None:
        if self.host_budget_bytes is None:
            return
        warm = sorted((e for e in self._entries.values()
                       if e.tier == TIER_WARM), key=lambda e: e.lru)
        for e in warm:
            if self._stats.bytes_warm <= self.host_budget_bytes:
                return
            self._spill_warm(e)

    def _spill_warm(self, e: _Entry) -> None:
        path = self._spill_path(e.doc_id)
        # companions captured at eviction time, NOT read from the live doc:
        # between eviction and spill a take may have mutated the host-side
        # allocator/watermarks past the snapshotted state. The spill is a
        # FULL serving snapshot (mirrors + meta, also eviction-time) so a
        # fleet peer can adopt it on failover; its meta carries the
        # consistency flag recorded at eviction. Write is atomic
        # (checkpoint.atomic_savez): a crash mid-spill never leaves a
        # truncated file at the visible path.
        ids, invalid_from, touched_from = e.warm_meta
        meta = dict(e.warm_mirrors["meta"])
        meta["invalid_from"] = invalid_from
        meta["touched_from"] = touched_from
        save_serving_document(path, e.warm, allocator_ids=ids,
                              mirrors=e.warm_mirrors["mirrors"], meta=meta)
        e.cold_path = path
        e.cold_ids = np.asarray(ids, np.int32).copy()
        e.warm = None
        e.warm_meta = None
        e.warm_mirrors = None
        e.tier = TIER_COLD
        self._stats.bytes_warm -= e.nbytes
        self._stats.docs_warm -= 1
        self._stats.bytes_cold += e.nbytes
        self._stats.docs_cold += 1
        self._stats.spills += 1
