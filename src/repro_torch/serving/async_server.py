"""Deadline-batching async front end over ``BatchServer`` — the PyTorch
port of ``repro/serving/async_server.py`` (read its module docstring for the
design; the code is the reference's, it makes no framework calls).

1. **Concurrent admission.** Any thread may ``open_document`` /
   ``submit_replace|insert|delete`` / ``suggest`` / ``subscribe``; requests
   land in one admission queue with their arrival time and return a
   ``Ticket``. The inner ``BatchServer`` — and with it every CUDA call — is
   touched ONLY by the scheduler thread, so the server's invariants carry
   over unchanged and the kernels' arrival counts keep one stream
   (``kernels/_launch.py``).
2. **Deadline batching.** A round dispatches when ``bucket_docs`` distinct
   documents have admitted work, or when ``max_batch_delay_ms`` has passed
   since the round's oldest admission.
3. **Coalescing.** A document's edits admitted before the round drain into
   its FIFO queue together and ship as one take; opens admitted in one
   window ingest through one ``open_documents`` dispatch.
4. **Streaming.** ``subscribe`` returns a ``SuggestionStream``: every real
   refresh pushes ``("token", serial, index, token)`` events as the decode
   loop yields them, then one ``("suggestion", serial, tokens)`` event.
5. **Latency SLOs.** Admission-to-completion latency per edit and per
   suggestion goes into ``BatchStats.edit_latency`` / ``suggest_latency``
   (``serving.latency``).

Exactness contract (``tests/test_torch_async_server.py``): any interleaving
of client threads yields final documents and suggestion tokens identical to
a sequential ``BatchServer`` fed each document's requests in the same
per-document order.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.edits import Edit
from repro_torch.serving.batch_server import BatchServer


class Ticket:
    """A latch the scheduler thread resolves when the request is served.

    ``result(timeout)`` blocks for the request's value (None for edits),
    re-raising the scheduler-side exception if the request failed —
    submission errors (bad position, unknown document) surface here instead
    of crashing the serving loop."""

    __slots__ = ("doc_id", "admit_t", "_event", "_value", "_error")

    def __init__(self, doc_id: Optional[str]):
        self.doc_id = doc_id
        self.admit_t = time.perf_counter()
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request for {self.doc_id!r} not served in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    # scheduler side
    def _resolve(self, value=None) -> None:
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class SuggestionStream:
    """Subscriber endpoint for one document's suggestion updates.

    Events (in order per refresh, ``serial`` strictly increasing):

    * ``("token", serial, index, token)`` — one decoded token, pushed as
      the decode loop produces it;
    * ``("suggestion", serial, tokens)`` — the complete refreshed
      continuation (np.int32 array);
    * ``("closed", None, None)`` — the document closed or the front end
      shut down; no further events.
    """

    def __init__(self, doc_id: str, n_new: int):
        self.doc_id = doc_id
        self.n_new = int(n_new)
        self._q: Queue = Queue()

    def get(self, timeout: Optional[float] = None) -> tuple:
        try:
            return self._q.get(timeout=timeout)
        except Empty:
            raise TimeoutError(
                f"no suggestion event for {self.doc_id!r} in {timeout}s")

    def next_suggestion(self, timeout: Optional[float] = None
                        ) -> tuple[int, np.ndarray]:
        """Block for the next COMPLETE continuation; token events before it
        are consumed (callers that want them use ``get``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            kind, serial, *rest = self.get(left)
            if kind == "suggestion":
                return serial, rest[0]
            if kind == "closed":
                raise RuntimeError(f"stream for {self.doc_id!r} closed")

    # scheduler side
    def _push(self, event: tuple) -> None:
        self._q.put(event)


@dataclass
class AsyncStats:
    """Scheduling-round accounting for the deadline batcher."""

    rounds: int = 0
    deadline_rounds: int = 0  # dispatched because max_batch_delay_ms expired
    full_rounds: int = 0  # dispatched because the bucket filled first
    admitted_edits: int = 0
    admitted_suggests: int = 0
    admitted_opens: int = 0
    requests_failed: int = 0  # tickets resolved with an exception

    @property
    def mean_edits_per_round(self) -> float:
        return self.admitted_edits / max(self.rounds, 1)


class AsyncBatchServer:
    """Event-loop serving front end: concurrent admission, deadline
    batching, per-document coalescing, suggestion streaming, latency SLOs.

    One scheduler thread owns the wrapped ``BatchServer``; every public
    method is safe from any thread and returns either a ``Ticket`` or a
    ``SuggestionStream``. Use as a context manager, or call ``close()``
    (which drains admitted work before stopping).
    """

    def __init__(self, server: BatchServer, *,
                 max_batch_delay_ms: float = 10.0,
                 bucket_docs: Optional[int] = None):
        if max_batch_delay_ms < 0:
            raise ValueError("max_batch_delay_ms must be >= 0")
        self.server = server
        self.max_batch_delay_ms = float(max_batch_delay_ms)
        self.bucket_docs = int(bucket_docs or server.max_batch)
        if self.bucket_docs < 1:
            raise ValueError("bucket_docs must be >= 1")
        self.stats = AsyncStats()
        self._cond = threading.Condition()
        self._requests: deque = deque()  # (kind, ticket, payload)
        self._subs: dict[str, list[SuggestionStream]] = {}
        self._subs_lock = threading.Lock()
        self._stream_idx: Optional[list] = None  # [(doc, serial), next index]
        self._stop = False
        server.on_suggest_token = self._stream_token
        self._thread = threading.Thread(
            target=self._loop, name="repro-torch-async-serve", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ client API

    def open_document(self, doc_id: str, tokens: Sequence[int]) -> Ticket:
        """Admit a session open. Opens admitted within one deadline window
        ingest through a single batched ``open_documents`` dispatch."""
        return self._admit("open", doc_id, list(tokens))

    def close_document(self, doc_id: str) -> Ticket:
        """Admit a session close. Like the synchronous server, closing
        discards the document's still-queued edits — await your edit
        tickets before closing if they must land."""
        return self._admit("close", doc_id, None)

    def submit_replace(self, doc_id: str, pos: int, tok: int) -> Ticket:
        return self._admit("edit", doc_id, ("replace", int(pos), int(tok)))

    def submit_insert(self, doc_id: str, pos: int, tok: int) -> Ticket:
        return self._admit("edit", doc_id, ("insert", int(pos), int(tok)))

    def submit_delete(self, doc_id: str, pos: int) -> Ticket:
        return self._admit("edit", doc_id, ("delete", int(pos), 0))

    def submit_edit(self, doc_id: str, e: Edit) -> Ticket:
        if e.op == "replace":
            return self.submit_replace(doc_id, e.pos, e.token)
        if e.op == "insert":
            return self.submit_insert(doc_id, e.pos, e.token)
        return self.submit_delete(doc_id, e.pos)

    def suggest(self, doc_id: str, n_new: int = 8) -> Ticket:
        """Admit a one-shot suggestion request; ``result()`` is the greedy
        continuation AFTER every edit admitted before it applied (the
        document stays subscribed at ``n_new``, like ``BatchServer.suggest``)."""
        return self._admit("suggest", doc_id, int(n_new))

    def subscribe(self, doc_id: str, n_new: int = 8) -> SuggestionStream:
        """Open a standing suggestion subscription with streaming delivery:
        after every round that leaves the document's suggestion stale, the
        refresh pushes token events to the returned stream."""
        stream = SuggestionStream(doc_id, n_new)
        with self._subs_lock:
            self._subs.setdefault(doc_id, []).append(stream)
        self._admit("subscribe", doc_id, stream)
        return stream

    def unsubscribe(self, stream: SuggestionStream) -> None:
        with self._subs_lock:
            streams = self._subs.get(stream.doc_id, [])
            if stream in streams:
                streams.remove(stream)
                if not streams:
                    self._subs.pop(stream.doc_id, None)
        stream._push(("closed", None, None))

    def tokens(self, doc_id: str) -> Ticket:
        """Admit a read of the document's (flushed) tokens in sequence
        order — serialized through the scheduler like every other touch."""
        return self._admit("tokens", doc_id, None)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every request admitted before this call is served."""
        self._admit("barrier", None, None).result(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain admitted work, stop the scheduler thread, close streams.
        Idempotent; the wrapped (now-quiescent) ``BatchServer`` remains
        usable synchronously afterwards."""
        with self._cond:
            if self._stop and not self._thread.is_alive():
                return
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("async scheduler did not stop in time")
        self.server.on_suggest_token = None
        with self._subs_lock:
            streams = [s for ss in self._subs.values() for s in ss]
            self._subs.clear()
        for s in streams:
            s._push(("closed", None, None))

    def __enter__(self) -> "AsyncBatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- admission

    def _admit(self, kind: str, doc_id: Optional[str], payload) -> Ticket:
        ticket = Ticket(doc_id)
        with self._cond:
            if self._stop:
                raise RuntimeError("async server is closed")
            self._requests.append((kind, ticket, payload))
            self._cond.notify_all()
        return ticket

    def _ready_docs(self) -> int:
        """Distinct documents with admitted dispatchable work (held lock)."""
        return len({t.doc_id for kind, t, _ in self._requests
                    if kind in ("edit", "open")})

    # ------------------------------------------------------------- scheduler

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._requests and not self._stop:
                    self._cond.wait()
                if not self._requests:  # stopping, fully drained
                    break
                full = False
                if not self._stop:  # draining rounds skip the deadline wait
                    deadline = (self._requests[0][1].admit_t
                                + self.max_batch_delay_ms / 1e3)
                    while not self._stop:
                        if self._ready_docs() >= self.bucket_docs:
                            full = True
                            break
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                batch = list(self._requests)
                self._requests.clear()
            self._run_round(batch, full)

    def _run_round(self, batch: list, full: bool) -> None:
        srv = self.server
        self.stats.rounds += 1
        if full:
            self.stats.full_rounds += 1
        else:
            self.stats.deadline_rounds += 1

        # ---- phase 1: apply admissions to the inner server's queues, in
        # admission order. Consecutive opens buffer into ONE batched ingest;
        # any other request first flushes the open buffer, so a client that
        # fires open->edit without waiting still sees its order preserved.
        edit_tickets: list[Ticket] = []
        suggest_reqs: list[tuple[Ticket, str, int]] = []
        barriers: list[Ticket] = []
        pending_opens: dict[str, tuple[Ticket, list]] = {}

        def flush_opens() -> None:
            if not pending_opens:
                return
            items = {d: toks for d, (t, toks) in pending_opens.items()}
            try:
                srv.open_documents(items)
                self.stats.admitted_opens += len(items)
                for t, _ in pending_opens.values():
                    t._resolve()
            except Exception:
                # one bad document must not strand the batch: retry one by
                # one so only the culprit's ticket carries the error
                for d, (t, toks) in pending_opens.items():
                    try:
                        srv.open_documents({d: toks})
                        self.stats.admitted_opens += 1
                        t._resolve()
                    except Exception as e:
                        self.stats.requests_failed += 1
                        t._fail(e)
            pending_opens.clear()

        for kind, ticket, payload in batch:
            try:
                if kind == "open":
                    pending_opens[ticket.doc_id] = (ticket, payload)
                    continue
                flush_opens()
                if kind == "edit":
                    op, pos, tok = payload
                    if op == "replace":
                        srv.submit_replace(ticket.doc_id, pos, tok)
                    elif op == "insert":
                        srv.submit_insert(ticket.doc_id, pos, tok)
                    else:
                        srv.submit_delete(ticket.doc_id, pos)
                    edit_tickets.append(ticket)
                elif kind == "suggest":
                    srv.submit_suggest(ticket.doc_id, payload)
                    suggest_reqs.append((ticket, ticket.doc_id, payload))
                elif kind == "subscribe":
                    srv.submit_suggest(ticket.doc_id, payload.n_new)
                    ticket._resolve()
                elif kind == "close":
                    self._close_streams(ticket.doc_id)
                    srv.close_document(ticket.doc_id)
                    ticket._resolve()
                elif kind == "tokens":
                    ticket._resolve(srv.tokens(ticket.doc_id))
                elif kind == "barrier":
                    barriers.append(ticket)
                else:  # pragma: no cover - admission kinds are internal
                    raise AssertionError(f"unknown request kind {kind!r}")
            except Exception as e:
                self.stats.requests_failed += 1
                ticket._fail(e)
        flush_opens()

        # ---- phase 2: one synchronous scheduling drain. flush() groups the
        # coalesced per-document queues into capacity-bucketed dispatches
        # and refreshes every stale subscription (snapshot/rollback and the
        # oracle guarantees are the inner scheduler's, untouched).
        serials = {d_id: d.suggest_serial for d_id, d in srv.docs.items()}
        try:
            srv.flush()
        except Exception as e:
            # dispatch failure: the inner scheduler rolled every affected
            # document back and KEPT its queued edits, so the work retries
            # with the next round; these tickets report the failure
            for t in edit_tickets:
                self.stats.requests_failed += 1
                t._fail(e)
            for t, _, _ in suggest_reqs:
                self.stats.requests_failed += 1
                t._fail(e)
            for t in barriers:
                t._fail(e)
            return

        now = time.perf_counter()
        for t in edit_tickets:
            srv.stats.edit_latency.record((now - t.admit_t) * 1e3)
            t._resolve()
        self.stats.admitted_edits += len(edit_tickets)

        for t, doc_id, n_new in suggest_reqs:
            try:
                out = srv.suggest(doc_id, n_new)  # fresh -> cached, no work
            except Exception as e:
                self.stats.requests_failed += 1
                t._fail(e)
                continue
            srv.stats.suggest_latency.record(
                (time.perf_counter() - t.admit_t) * 1e3)
            t._resolve(out)
        self.stats.admitted_suggests += len(suggest_reqs)

        # ---- phase 3: deliver refreshed subscriptions. Token events were
        # already streamed live from the decode loop; completed
        # continuations are pushed here, and edit-triggered refreshes (no
        # explicit suggest ticket) record their latency from the round's
        # oldest admission — the queueing delay is part of the SLO.
        round_t0 = min((t.admit_t for _, t, _ in batch), default=now)
        explicit = {doc_id for _, doc_id, _ in suggest_reqs}
        with self._subs_lock:
            subscribed = {d: list(ss) for d, ss in self._subs.items()}
        for doc_id, streams in subscribed.items():
            doc = srv.docs.get(doc_id)
            if doc is None or not doc.suggest_fresh:
                continue
            if doc.suggest_serial == serials.get(doc_id):
                continue  # nothing new since the last delivery
            if doc_id not in explicit:
                srv.stats.suggest_latency.record(
                    (time.perf_counter() - round_t0) * 1e3)
            event = ("suggestion", doc.suggest_serial, doc.suggestion.copy())
            for s in streams:
                s._push(event)
        for t in barriers:
            t._resolve()

    # ------------------------------------------------------------- streaming

    def _stream_token(self, doc_id: str, serial: int, token: int) -> None:
        """BatchServer.on_suggest_token hook: forward one decoded token to
        the document's subscribers the moment the decode loop yields it."""
        with self._subs_lock:
            streams = list(self._subs.get(doc_id, ()))
        if not streams:
            return
        idx = self._stream_idx
        if idx is None or idx[0] != (doc_id, serial):
            self._stream_idx = idx = [(doc_id, serial), 0]
        for s in streams:
            s._push(("token", serial, idx[1], int(token)))
        idx[1] += 1

    def _close_streams(self, doc_id: str) -> None:
        with self._subs_lock:
            streams = self._subs.pop(doc_id, [])
        for s in streams:
            s._push(("closed", None, None))
