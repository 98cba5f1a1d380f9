"""``FleetRouter``: document placement, sticky routing, migration, failover
— the port of ``repro/serving/fleet/router.py``.

The workers are ``python -m repro_torch.serving.fleet.worker`` subprocesses;
``device=`` (default ``"cuda"``) is forwarded to them, so several replicas
share one card (or run on the CPU in the tests), each building the same
seeded weights. ``device`` may also be a list with one device per replica
(``["cuda:0", "cuda:1"]``: a replica per card).

The router is the fleet's single control point (DESIGN.md §11). It spawns N
replica workers (``fleet.worker`` subprocesses), speaks the framed RPC of
``fleet.protocol`` to each over its stdin/stdout pipes, and exposes the
familiar ``open / edit / suggest / tokens / close`` surface — every call
returns the same ``Ticket`` latch the async front end uses, so a client
cannot tell one replica from a fleet.

Placement and routing:

* **greedy least-loaded admission** — a new document lands on the replica
  with the smallest (estimated hot bytes, in-flight edits, open docs)
  triple; the byte estimate is ``state_nbytes_for_config`` at the
  document's capacity class, the same arithmetic the serving budget uses;
* **sticky routing** — after admission every request for a document goes to
  its owner (per-document FIFO order is the exactness contract), until an
  explicit ``migrate`` or a failover moves it.

Per replica, ONE rpc thread drains a queue of (op, ticket) pairs and ships
them as a single frame per round trip — the wire-level analogue of deadline
batching: a burst coalesces into one frame, lands in the worker's scheduler
together, and resolves as one response frame.

Acked-token mirrors and exactly-once failover: the router applies each
acked edit to a host-side token mirror of every document. When a replica
dies, each of its documents is reconstructed on a survivor **to exactly the
acked mirror** — by adopting the shared-cold-tier snapshot and applying a
repair edit script (snapshot -> mirror, which also REVERTS edits the dead
replica applied but never acked), or by re-opening from the mirror when no
usable snapshot exists. In-flight tickets fail with ``ReplicaDiedError``
and the client replays them; because recovery rolled the document to the
acked prefix, a replay can never double-apply (DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Optional, Sequence

import numpy as np

from repro_torch.common.bucketing import capacity_class, next_pow2
from repro_torch.configs import get_config
from repro_torch.core.edits import Edit, apply_edit, edit_script
from repro_torch.serving.async_server import Ticket
from repro_torch.serving.fleet import cold_tier
from repro_torch.serving.fleet.protocol import send_msg, recv_msg
from repro_torch.serving.jit_engine import state_nbytes_for_config
from repro_torch.serving.latency import LatencyStats
from repro_torch.serving.state_store import cold_path_for

_FRAME_OPS = 64  # max ops coalesced per RPC frame
_READY_TIMEOUT_S = 600.0  # worker boot = torch import + params init
_RECOVER_TIMEOUT_S = 600.0  # failover import/reopen may pay a first build


class ReplicaDiedError(RuntimeError):
    """The owning replica died before acknowledging this request. The
    document has been reconstructed on a survivor at its ACKED prefix, so
    replaying the failed request is safe (never double-applies)."""


class RemoteOpError(RuntimeError):
    """The worker served the op and reported an application error."""

    def __init__(self, message: str, cls: str = "Exception"):
        super().__init__(message)
        self.remote_cls = cls


@dataclass
class FleetStats:
    """Router-side counters; ``FleetRouter.stats()`` merges these with the
    per-replica ``BatchStats``/``AsyncStats`` aggregation."""

    replicas: int = 0
    replicas_dead: int = 0
    docs_opened: int = 0
    docs_closed: int = 0
    migrations: int = 0
    failovers: int = 0  # dead replicas recovered
    failover_rehydrations: int = 0  # docs adopted from a cold snapshot
    failover_reopens: int = 0  # docs re-opened from the acked token mirror
    repair_edits: int = 0  # snapshot -> acked-mirror repair ops applied


def worker_specs(n_replicas: int, device, **common) -> list[dict]:
    """Each replica worker's spec: ``common`` plus its name and its device —
    ``device`` itself for every replica, or, from a list or tuple, the
    replica's own entry (the list must hold one per replica)."""
    if isinstance(device, (list, tuple)):
        if len(device) != n_replicas:
            raise ValueError(f"{len(device)} devices for {n_replicas} replicas")
        devices = [str(d) for d in device]
    else:
        devices = [str(device)] * n_replicas
    return [{**common, "device": dev, "replica": f"r{idx}"}
            for idx, dev in enumerate(devices)]


class _Replica:
    """Router-side handle: the subprocess, its RPC thread, and its load
    accounting (docs owned, in-flight edits, estimated hot bytes)."""

    def __init__(self, idx: int, proc: subprocess.Popen):
        self.idx = idx
        self.name = f"r{idx}"
        self.proc = proc
        self.queue: Queue = Queue()
        self.alive = True
        self.dead_event = threading.Event()  # set AFTER failover completes
        self.docs: set[str] = set()
        self.inflight = 0
        self.est_bytes = 0
        self.lock = threading.Lock()
        self.thread: Optional[threading.Thread] = None
        self._frame_id = 0
        self.boot_s: Optional[float] = None  # spawn -> ready frame, wall

    def load_key(self) -> tuple:
        with self.lock:
            return (self.est_bytes, self.inflight, len(self.docs), self.idx)


class FleetRouter:
    """See module docstring. Typical use::

        with FleetRouter(2, cold_dir=shared) as fleet:
            fleet.open_document("a", tokens).result()
            fleet.submit_insert("a", 3, 17)
            toks = fleet.tokens("a").result()
            print(fleet.stats()["edits_applied"])
    """

    def __init__(self, n_replicas: int, *, arch: str = "vq-opt-125m",
                 smoke: bool = True, seed: int = 0,
                 cold_dir: Optional[str] = None,
                 server_kwargs: Optional[dict] = None,
                 max_batch_delay_ms: float = 5.0,
                 bucket_docs: Optional[int] = None,
                 heartbeat_interval_s: Optional[float] = 2.0,
                 worker_env: Optional[dict] = None, device="cuda"):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.arch = arch
        self.smoke = smoke
        self.seed = seed
        self.device = device
        self.cold_dir = cold_dir or tempfile.mkdtemp(prefix="repro-torch-fleet-")
        os.makedirs(self.cold_dir, exist_ok=True)
        self.server_kwargs = dict(server_kwargs or {})
        self.stats_fleet = FleetStats()
        self._route: dict[str, _Replica] = {}
        self._route_lock = threading.RLock()
        self._mirrors: dict[str, list[int]] = {}  # doc -> ACKED tokens
        self._suggest_n: dict[str, int] = {}  # doc -> standing request length
        self._doc_est: dict[str, int] = {}  # doc -> admission byte estimate
        self._mirror_lock = threading.Lock()
        self._closed = False
        # capacity-class arithmetic mirrors BatchServer's defaults so the
        # byte estimate matches what the replica will actually admit
        self._min_cap = next_pow2(self.server_kwargs.get("min_doc_capacity", 16))
        self._cap_step = self.server_kwargs.get("capacity_class_step", 4)
        self._cfg = get_config(arch, smoke=smoke)

        specs = worker_specs(
            n_replicas, device, arch=arch, smoke=smoke, seed=seed,
            cold_dir=self.cold_dir, server_kwargs=self.server_kwargs,
            async_kwargs={"max_batch_delay_ms": max_batch_delay_ms,
                          **({"bucket_docs": bucket_docs}
                             if bucket_docs else {})})
        env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(worker_env or {})
        self.replicas: list[_Replica] = []
        t_spawn = time.perf_counter()
        for idx in range(n_replicas):
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.serving.fleet.worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=None, env=env)
            r = _Replica(idx, proc)
            send_msg(proc.stdin, specs[idx])
            self.replicas.append(r)
        # readiness: workers boot in parallel (each pays the torch import and
        # the param init); collect the ready frames after all spawns
        for r in self.replicas:
            ready = self._recv_with_deadline(r, _READY_TIMEOUT_S)
            if not ready.get("ok"):
                self._kill_all()
                raise RuntimeError(
                    f"replica {r.name} failed to start: {ready.get('error')}")
            r.boot_s = time.perf_counter() - t_spawn
            r.thread = threading.Thread(
                target=self._rpc_loop, args=(r,),
                name=f"repro-fleet-rpc-{r.name}", daemon=True)
            r.thread.start()
        self.stats_fleet.replicas = n_replicas
        self._hb_stop = threading.Event()
        self._hb_thread = None
        if heartbeat_interval_s:
            self._hb_thread = threading.Thread(
                target=self._heartbeat, args=(float(heartbeat_interval_s),),
                name="repro-fleet-heartbeat", daemon=True)
            self._hb_thread.start()

    # ------------------------------------------------------------ client API

    def open_document(self, doc_id: str, tokens: Sequence[int],
                      replica: Optional[int] = None) -> Ticket:
        toks = [int(t) for t in tokens]
        with self._route_lock:
            if self._closed:
                raise RuntimeError("fleet is closed")
            if doc_id in self._route:
                raise KeyError(f"document {doc_id!r} already open")
            r = (self.replicas[replica] if replica is not None
                 else self._least_loaded())
            r.docs.add(doc_id)
            self._doc_est[doc_id] = self._est_bytes(len(toks))
            with r.lock:
                r.est_bytes += self._doc_est[doc_id]
            self._route[doc_id] = r
            self.stats_fleet.docs_opened += 1
            return self._enqueue(r, {"op": "open", "doc_id": doc_id,
                                     "tokens": toks})

    def close_document(self, doc_id: str) -> Ticket:
        with self._route_lock:
            r = self._owner(doc_id)
            ticket = self._enqueue(r, {"op": "close", "doc_id": doc_id})
            r.docs.discard(doc_id)
            with r.lock:
                r.est_bytes -= self._doc_est.pop(doc_id, 0)
            self._route.pop(doc_id, None)
            self.stats_fleet.docs_closed += 1
            return ticket

    def submit_replace(self, doc_id: str, pos: int, tok: int) -> Ticket:
        return self._submit_edit(doc_id, ("replace", int(pos), int(tok)))

    def submit_insert(self, doc_id: str, pos: int, tok: int) -> Ticket:
        return self._submit_edit(doc_id, ("insert", int(pos), int(tok)))

    def submit_delete(self, doc_id: str, pos: int) -> Ticket:
        return self._submit_edit(doc_id, ("delete", int(pos), 0))

    def submit_edit(self, doc_id: str, e: Edit) -> Ticket:
        if e.op == "replace":
            return self.submit_replace(doc_id, e.pos, e.token)
        if e.op == "insert":
            return self.submit_insert(doc_id, e.pos, e.token)
        return self.submit_delete(doc_id, e.pos)

    def suggest(self, doc_id: str, n_new: int = 8) -> Ticket:
        with self._route_lock:
            r = self._owner(doc_id)
            with self._mirror_lock:
                self._suggest_n[doc_id] = int(n_new)
            return self._enqueue(r, {"op": "suggest", "doc_id": doc_id,
                                     "n_new": int(n_new)})

    def tokens(self, doc_id: str) -> Ticket:
        with self._route_lock:
            return self._enqueue(self._owner(doc_id),
                                 {"op": "tokens", "doc_id": doc_id})

    def logits(self, doc_id: str) -> Ticket:
        with self._route_lock:
            return self._enqueue(self._owner(doc_id),
                                 {"op": "logits", "doc_id": doc_id})

    def evict(self, doc_id: str, tier: str = "warm") -> Ticket:
        with self._route_lock:
            return self._enqueue(self._owner(doc_id),
                                 {"op": "evict", "doc_id": doc_id,
                                  "tier": tier})

    def owner_of(self, doc_id: str) -> int:
        with self._route_lock:
            return self._owner(doc_id).idx

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every request admitted before this call is acked on
        every live replica."""
        with self._route_lock:
            tickets = [self._enqueue(r, {"op": "barrier"})
                       for r in self.replicas if r.alive]
        for t in tickets:
            t.result(timeout)

    def ping(self, timeout: Optional[float] = None) -> list:
        with self._route_lock:
            tickets = [(r.name, self._enqueue(r, {"op": "ping"}))
                       for r in self.replicas if r.alive]
        return [(name, t.result(timeout)) for name, t in tickets]

    # ------------------------------------------------------------- migration

    def migrate(self, doc_id: str, to_replica: int) -> None:
        """Move a live document: flush + snapshot + close on the owner
        (``export``), adopt on the target (``import``) — the store's evict/
        rehydrate machinery pointed across processes, so the move is
        bit-exact. Blocking; concurrent submissions for the document are
        held (the routing lock) until the new owner has adopted it."""
        with self._route_lock:
            src = self._owner(doc_id)
            dst = self.replicas[to_replica]
            if not dst.alive:
                raise ReplicaDiedError(f"target replica r{to_replica} is dead")
            if src is dst:
                return
            self._enqueue(src, {"op": "export",
                                "doc_id": doc_id}).result(_RECOVER_TIMEOUT_S)
            self._enqueue(dst, {"op": "import", "doc_id": doc_id,
                                "remove": True}).result(_RECOVER_TIMEOUT_S)
            nbytes = self._doc_est.get(doc_id, 0)
            src.docs.discard(doc_id)
            with src.lock:
                src.est_bytes -= nbytes
            dst.docs.add(doc_id)
            with dst.lock:
                dst.est_bytes += nbytes
            self._route[doc_id] = dst
            self.stats_fleet.migrations += 1

    def reset_latency(self, timeout: Optional[float] = None) -> None:
        """Zero every live replica's per-request latency histograms — the
        benchmark timing protocol (warmup pays the jit compiles, then the
        measured pass restarts the histograms; cf. benchmarks.async_load)."""
        with self._route_lock:
            tickets = [self._enqueue(r, {"op": "reset_latency"})
                       for r in self.replicas if r.alive]
        for t in tickets:
            t.result(timeout)

    def checkpoint(self, timeout: Optional[float] = None) -> None:
        """Snapshot every open document to the shared cold tier (each
        replica flushes first). Bounds failover's reopen-and-replay to the
        edits acked since this call."""
        with self._route_lock:
            tickets = [self._enqueue(r, {"op": "checkpoint"})
                       for r in self.replicas if r.alive]
        for t in tickets:
            t.result(timeout)

    def kill_replica(self, idx: int, timeout: float = _RECOVER_TIMEOUT_S) -> None:
        """Hard-kill a replica (failover test/chaos hook) and block until
        its documents have been reassigned to survivors."""
        r = self.replicas[idx]
        r.proc.kill()
        # the rpc thread may be idle on queue.get: a ping makes it touch the
        # dead pipe and discover the EOF
        try:
            self._enqueue(r, {"op": "ping"})
        except ReplicaDiedError:
            pass
        if not r.dead_event.wait(timeout):
            raise TimeoutError(f"replica r{idx} failover did not complete")

    # ------------------------------------------------------------- lifecycle

    def close_fleet(self, timeout: float = 60.0) -> None:
        """Close every document, shut every worker down, reap processes.
        Leak-free: afterwards no subprocess survives and the shared cold
        directory holds no document files or leases
        (tests/test_fleet.py)."""
        with self._route_lock:
            if self._closed:
                return
            self._closed = True
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        for doc_id in list(self._route):
            try:
                self.close_document(doc_id).result(timeout)
            except (ReplicaDiedError, RemoteOpError):
                pass
        for r in self.replicas:
            if r.alive:
                try:
                    self._enqueue(r, {"op": "shutdown"})
                except ReplicaDiedError:
                    pass
            r.queue.put(None)  # rpc-thread sentinel
        for r in self.replicas:
            if r.thread is not None:
                r.thread.join(timeout)
            try:
                if r.proc.stdin:
                    r.proc.stdin.close()
            except OSError:
                pass
            try:
                r.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                r.proc.kill()
                r.proc.wait(10)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close_fleet()

    # ------------------------------------------------------------- aggregation

    def stats(self, timeout: Optional[float] = None) -> dict:
        """Fleet-level aggregation: sums of every replica's ``BatchStats``
        counters, concatenated latency reservoirs (fleet p50/p99), the
        fleet hot-hit rate, and the router's own counters. Each replica
        drains before reporting, so the totals reconcile exactly with the
        sum of acked work (tests/test_fleet.py::test_stats_reconcile)."""
        with self._route_lock:
            tickets = [self._enqueue(r, {"op": "stats"})
                       for r in self.replicas if r.alive]
        per_replica = [t.result(timeout) for t in tickets]
        agg: dict = {"per_replica": per_replica,
                     "router": dataclasses.asdict(self.stats_fleet),
                     "docs_open": len(self._route),
                     "replicas_alive": len(per_replica),
                     "boot_s": [r.boot_s for r in self.replicas]}
        for field_name in ("edits_applied", "edits_submitted", "docs",
                           "closes", "batch_steps", "full_forwards",
                           "suggest_refreshes", "suggest_cached_hits",
                           "evictions", "spills", "rehydrations",
                           "hot_hits", "state_touches", "exports",
                           "imports"):
            agg[field_name] = sum(s["batch"][field_name] for s in per_replica)
        for field_name in ("rounds", "deadline_rounds", "full_rounds",
                           "admitted_edits", "admitted_suggests",
                           "requests_failed"):
            agg[field_name] = sum(s["async"][field_name] for s in per_replica)
        agg["hot_hit_rate"] = (agg["hot_hits"] / agg["state_touches"]
                               if agg["state_touches"] else 1.0)
        for lat in ("edit_latency", "suggest_latency"):
            merged = LatencyStats()
            samples: list[float] = []
            for s in per_replica:
                rec = s["batch"][lat]
                merged.count += rec["count"]
                merged.total_ms += rec["total_ms"]
                merged.max_ms = max(merged.max_ms, rec["max_ms"])
                samples.extend(rec["samples"])
            merged.samples = samples
            agg[lat] = merged.summary()
        return agg

    # ------------------------------------------------------------- internals

    def _owner(self, doc_id: str) -> _Replica:
        r = self._route.get(doc_id)
        if r is None:
            raise KeyError(f"document {doc_id!r} is not open on this fleet")
        return r

    def _least_loaded(self) -> _Replica:
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise ReplicaDiedError("no live replicas")
        return min(live, key=_Replica.load_key)

    def _est_bytes(self, n_tokens: int) -> int:
        n_cap = capacity_class(max(n_tokens, 1), self._min_cap, self._cap_step)
        return state_nbytes_for_config(self._cfg, n_cap)

    def _submit_edit(self, doc_id: str, e: tuple) -> Ticket:
        with self._route_lock:
            r = self._owner(doc_id)
            with r.lock:
                r.inflight += 1
            return self._enqueue(r, {"op": "edit", "doc_id": doc_id,
                                     "edit": e, "track": True})

    def _enqueue(self, r: _Replica, op: dict) -> Ticket:
        if not r.alive:
            raise ReplicaDiedError(f"replica {r.name} is dead")
        ticket = Ticket(op.get("doc_id"))
        r.queue.put((op, ticket))
        return ticket

    def _recv_with_deadline(self, r: _Replica, timeout: float):
        """Blocking ready-frame read with a watchdog that kills the worker
        if it never reports (a hung import would otherwise hang the
        router)."""
        timer = threading.Timer(timeout, r.proc.kill)
        timer.start()
        try:
            return recv_msg(r.proc.stdout)
        except EOFError:
            return {"ok": False, "error": "worker exited before ready"}
        finally:
            timer.cancel()

    def _kill_all(self) -> None:
        for r in self.replicas:
            try:
                r.proc.kill()
            except OSError:
                pass

    # --------------------------------------------------------- rpc thread

    def _rpc_loop(self, r: _Replica) -> None:
        while True:
            item = r.queue.get()
            if item is None:
                return
            batch = [item]
            while len(batch) < _FRAME_OPS:
                try:
                    nxt = r.queue.get_nowait()
                except Empty:
                    break
                if nxt is None:
                    r.queue.put(None)  # keep the sentinel for after this frame
                    break
                batch.append(nxt)
            r._frame_id += 1
            try:
                send_msg(r.proc.stdin,
                         {"id": r._frame_id, "ops": [op for op, _ in batch]})
                resp = recv_msg(r.proc.stdout)
                results = resp["results"]
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"frame {r._frame_id}: {len(results)} results for "
                        f"{len(batch)} ops")
            except Exception:
                self._replica_died(r, batch)
                return
            for (op, ticket), res in zip(batch, results):
                self._settle(r, op, ticket, res)

    def _settle(self, r: _Replica, op: dict, ticket: Ticket, res: dict) -> None:
        if op["op"] == "edit":
            with r.lock:
                r.inflight -= 1
        if res.get("ok"):
            if op["op"] == "edit" and op.get("track"):
                self._mirror_apply(op["doc_id"], op["edit"])
            elif op["op"] == "open":
                with self._mirror_lock:
                    self._mirrors[op["doc_id"]] = list(op["tokens"])
            elif op["op"] == "close":
                with self._mirror_lock:
                    self._mirrors.pop(op["doc_id"], None)
                    self._suggest_n.pop(op["doc_id"], None)
            ticket._resolve(res.get("value"))
        else:
            ticket._fail(RemoteOpError(res.get("error", "remote failure"),
                                       res.get("cls", "Exception")))

    def _mirror_apply(self, doc_id: str, e: tuple) -> None:
        kind, pos, tok = e
        with self._mirror_lock:
            toks = self._mirrors.get(doc_id)
            if toks is None:
                return
            self._mirrors[doc_id] = apply_edit(toks, Edit(kind, pos, tok))

    # ----------------------------------------------------------- failover

    def _replica_died(self, r: _Replica, inflight_batch: list) -> None:
        """RPC-thread death handler: fail everything in flight FIRST (so a
        blocked ``migrate``/``flush`` holding the routing lock unblocks),
        then reassign the dead replica's documents under the routing lock."""
        r.alive = False
        self.stats_fleet.replicas_dead += 1
        try:
            r.proc.kill()
        except OSError:
            pass
        for _, ticket in inflight_batch:
            ticket._fail(ReplicaDiedError(
                f"replica {r.name} died before acking"))
        self._drain_dead_queue(r)
        try:
            with self._route_lock:
                if not self._closed:
                    self._recover_documents(r)
                    self.stats_fleet.failovers += 1
        finally:
            # late enqueues that raced the death: fail them too
            self._drain_dead_queue(r)
            r.dead_event.set()

    def _drain_dead_queue(self, r: _Replica) -> None:
        while True:
            try:
                item = r.queue.get_nowait()
            except Empty:
                return
            if item is None:
                continue
            op, ticket = item
            if op["op"] == "edit":
                with r.lock:
                    r.inflight -= 1
            ticket._fail(ReplicaDiedError(
                f"replica {r.name} died before acking"))

    def _recover_documents(self, dead: _Replica) -> None:
        """Reassign every document the dead replica owned. Target state is
        the ACKED token mirror exactly — snapshot adoption is followed by a
        repair edit script (which also reverts applied-but-unacked edits),
        and a missing/unusable snapshot falls back to a re-open from the
        mirror. Suggestion subscriptions re-establish on next request."""
        for doc_id in sorted(dead.docs):
            with self._mirror_lock:
                target = list(self._mirrors.get(doc_id, ()))
            try:
                self._recover_one(doc_id, target)
            except (RemoteOpError, ReplicaDiedError):
                # double failure mid-recovery: one retry on whatever
                # survivor remains, else the document is lost (its next
                # touch raises KeyError and the client re-opens)
                try:
                    self._recover_one(doc_id, target)
                except (RemoteOpError, ReplicaDiedError):
                    self._route.pop(doc_id, None)
                    self._doc_est.pop(doc_id, None)
        dead.docs.clear()

    def _recover_one(self, doc_id: str, target: list) -> None:
        dst = self._least_loaded()
        cold_tier.break_lease(self.cold_dir, doc_id)
        adopted = False
        if os.path.exists(cold_path_for(self.cold_dir, doc_id)):
            try:
                self._enqueue(dst, {"op": "import", "doc_id": doc_id,
                                    "remove": True}
                              ).result(_RECOVER_TIMEOUT_S)
                adopted = True
            except RemoteOpError:
                adopted = False  # inconsistent/corrupt snapshot: re-open
        if adopted:
            snap = list(self._enqueue(
                dst, {"op": "tokens", "doc_id": doc_id}
            ).result(_RECOVER_TIMEOUT_S))
            repairs = edit_script(snap, target) if snap != target else []
            for e in repairs:
                # track=False: the mirror already IS the repair target
                self._enqueue(dst, {"op": "edit", "doc_id": doc_id,
                                    "edit": (e.op, int(e.pos), int(e.token)),
                                    "track": False}
                              ).result(_RECOVER_TIMEOUT_S)
            self.stats_fleet.repair_edits += len(repairs)
            self.stats_fleet.failover_rehydrations += 1
        else:
            if not target:
                self._route.pop(doc_id, None)
                self._doc_est.pop(doc_id, None)
                return  # opened but never acked: nothing to recover
            self._enqueue(dst, {"op": "open", "doc_id": doc_id,
                                "tokens": target}
                          ).result(_RECOVER_TIMEOUT_S)
            self.stats_fleet.failover_reopens += 1
        n = self._suggest_n.get(doc_id)
        if n:
            self._enqueue(dst, {"op": "suggest", "doc_id": doc_id,
                                "n_new": n})
        dst.docs.add(doc_id)
        self._doc_est[doc_id] = self._est_bytes(len(target))
        with dst.lock:
            dst.est_bytes += self._doc_est[doc_id]
        self._route[doc_id] = dst

    # ---------------------------------------------------------- heartbeat

    def _heartbeat(self, interval: float) -> None:
        """Probe liveness: an exited process is discovered even when its
        rpc thread is idle (the ping forces a touch of the dead pipe)."""
        while not self._hb_stop.wait(interval):
            for r in self.replicas:
                if not r.alive or self._closed:
                    continue
                # a ping per beat is the whole probe: EOF/EPIPE on the pipe
                # is the death detector (never a timeout — a long kernel
                # build must not read as a dead replica), and it wakes an
                # idle rpc thread so an exited process is noticed promptly
                try:
                    self._enqueue(r, {"op": "ping"})
                except ReplicaDiedError:
                    pass


def fleet_tokens_exact(fleet_tokens: dict, oracle_tokens: dict) -> bool:
    """Convenience for harnesses: every document's final tokens match."""
    if set(fleet_tokens) != set(oracle_tokens):
        return False
    return all(np.array_equal(np.asarray(fleet_tokens[d]),
                              np.asarray(oracle_tokens[d]))
               for d in fleet_tokens)
