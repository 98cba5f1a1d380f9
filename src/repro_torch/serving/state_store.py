"""Document-state store — the hot tier of ``repro/serving/state_store.py``.

Every open document's ``JitState`` is device-resident ("hot"). The store
keeps the reference's interface on the serving path — ``register``,
``set_hot`` (adopt a replaced state and bump the document's
``state_epoch``, which the rollback path reads), ``ensure_hot`` (every
device-state read goes through it), ``close``, ``tier``,
``note_suggest_bytes`` (the suggestion decode caches, soft state) and the
byte/doc accounting in ``BatchStats`` — so the warm (host RAM) and cold (disk)
tiers, LRU eviction and the budgets can land later without touching the
scheduler. ``admit`` is a no-op: there is no budget to enforce yet.
"""
from __future__ import annotations

from repro_torch.serving.jit_engine import JitState, state_nbytes

TIER_HOT = "hot"


class StateStore:
    """Residency manager for ``BatchServer`` documents (hot tier only).
    ``stats`` is the server's ``BatchStats`` (authoritative counters)."""

    def __init__(self, *, stats):
        self._stats = stats
        self._nbytes: dict[str, int] = {}  # doc_id -> state footprint
        self._suggest: dict[str, int] = {}  # doc_id -> decode-cache bytes

    def tier(self, doc_id: str) -> str:
        if doc_id not in self._nbytes:
            raise KeyError(doc_id)
        return TIER_HOT

    def nbytes(self, doc_id: str) -> int:
        return self._nbytes[doc_id]

    def register(self, doc) -> None:
        """Adopt a freshly ingested document (its ``state`` is hot)."""
        if doc.doc_id in self._nbytes:
            raise KeyError(f"document {doc.doc_id!r} already in the store")
        self._nbytes[doc.doc_id] = state_nbytes(doc.state)
        self._stats.bytes_hot += self._nbytes[doc.doc_id]
        self._stats.docs_hot += 1

    def set_hot(self, doc, state: JitState) -> None:
        """Adopt a REPLACED device state (dispatch result, re-ingest, grow)
        and bump ``state_epoch`` so rollback can tell a content-changing
        replacement apart."""
        nbytes = state_nbytes(state)
        self._stats.bytes_hot += nbytes - self._nbytes[doc.doc_id]
        self._nbytes[doc.doc_id] = nbytes
        doc.state = state
        doc.state_epoch += 1

    def close(self, doc) -> None:
        """Release a closing document's state."""
        self._stats.bytes_hot -= self._nbytes.pop(doc.doc_id)
        self._stats.bytes_suggest -= self._suggest.pop(doc.doc_id, 0)
        self._stats.docs_hot -= 1
        doc.state = None

    def note_suggest_bytes(self, doc_id: str, nbytes: int) -> None:
        """Suggestion decode-cache accounting (the suggester's listener):
        keeps ``stats.bytes_suggest``. Keys the store does not manage (oracle
        harnesses) are ignored."""
        if doc_id not in self._nbytes:
            return
        delta = int(nbytes) - self._suggest.get(doc_id, 0)
        self._suggest[doc_id] = int(nbytes)
        self._stats.bytes_suggest += delta

    def admit(self, nbytes: int, keep: frozenset = frozenset()) -> None:
        """Make room for ``nbytes`` of incoming device state, protecting the
        documents in ``keep``: nothing to do without a device budget."""

    def ensure_hot(self, doc, keep: frozenset = frozenset()) -> JitState:
        """The device state of ``doc``, ready for a dispatch or a read
        (always resident in the hot-only store)."""
        return doc.state
