"""Replica worker: a subprocess owning one ``AsyncBatchServer`` — the port of
``repro/serving/fleet/worker.py``.

Spawned by ``FleetRouter`` as ``python -m repro_torch.serving.fleet.worker``.
The RPC transport is the stdin/stdout pipe pair in the length-prefixed
framing of ``fleet.protocol``; the FIRST frame on stdin is the replica spec
(arch, seed, device, cold directory, server knobs), after which the worker
answers request frames until stdin closes or a ``shutdown`` op arrives.

Determinism contract: every replica builds its parameters with the port's
seeded init, ``init_params(cfg, generator=torch.Generator().manual_seed(
seed))``, which draws on the CPU — so all replicas (and a router-side
oracle) hold bitwise-identical weights; that, plus the serving-snapshot
migration format, makes a migrated document indistinguishable from one that
never moved. ``device`` in the spec picks where the server runs: ``"cuda"``
by default, ``"cpu"`` in the CPU tests. The kernels' build cache
(``kernels/_build.py``: nvcc's output captured, libraries renamed into place
atomically) lets workers that start together share one build.

Two op families:

* **ticket ops** (``open`` / ``edit`` / ``suggest`` / ``tokens``) admit into
  the async front end and resolve when its scheduler serves them — many per
  frame pipeline into one deadline-batched round;
* **control ops** (``close`` / ``export`` / ``import`` / ``checkpoint`` /
  ``logits`` / ``evict`` / ``barrier`` / ``stats`` / ``shutdown``) first
  drain everything admitted before them (``AsyncBatchServer.flush``), then
  touch the inner ``BatchServer`` directly — safe because this process is
  the server's only client, and the drain preserves per-document order.

Nothing heavy is imported at module level: ``main`` claims the RPC pipe
before ``torch`` (or anything that could print) loads.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import traceback

from repro_torch.serving.fleet.protocol import recv_msg, send_msg

# tickets admitted by this worker resolve after at most one drain of its own
# scheduler; an hour means the scheduler thread is gone, not slow
_TICKET_TIMEOUT_S = 3600.0


class _Worker:
    def __init__(self, spec: dict):
        import torch

        from repro_torch.common.compile_cache import enable_persistent_compilation_cache
        from repro_torch.configs import get_config
        from repro_torch.models.transformer import init_params
        from repro_torch.serving.async_server import AsyncBatchServer
        from repro_torch.serving.batch_server import BatchServer
        from repro_torch.serving.fleet import cold_tier

        # workers inherit REPRO_COMPILE_CACHE_DIR from the router's
        # environment: every replica loads the same kernel builds (a no-op
        # when the variable is unset)
        enable_persistent_compilation_cache()
        self._cold_tier = cold_tier
        self.replica = spec["replica"]
        self.cold_dir = spec["cold_dir"]
        device = spec.get("device", "cuda")
        if str(device).startswith("cuda"):
            # the same f32 matmuls as any in-process server: TF32 off
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        cfg = get_config(spec.get("arch", "vq-opt-125m"),
                         smoke=spec.get("smoke", True))
        params = init_params(
            cfg, generator=torch.Generator().manual_seed(spec.get("seed", 0)),
            device="cpu")
        self.srv = BatchServer(params, cfg, spill_dir=self.cold_dir,
                               device=device, **spec.get("server_kwargs", {}))
        self.asrv = AsyncBatchServer(self.srv, **spec.get("async_kwargs", {}))

    # ---------------------------------------------------------------- ops

    def _cold_path(self, doc_id: str) -> str:
        return self._cold_tier.cold_path_for(self.cold_dir, doc_id)

    def handle_frame(self, ops: list) -> tuple[list, bool]:
        """Serve one request frame. Returns (results, keep_running)."""
        cold_tier = self._cold_tier
        results: list = [None] * len(ops)
        tickets: list = []  # (index, ticket) — resolved before returning
        shutdown = False

        def drain() -> None:
            """Order barrier before a control op: everything admitted so far
            (this frame's tickets included) is served."""
            self.asrv.flush()
            for i, t in tickets:
                results[i] = self._collect(t)
            tickets.clear()

        for i, op in enumerate(ops):
            kind = op["op"]
            try:
                if kind == "open":
                    cold_tier.acquire_lease(self.cold_dir, op["doc_id"],
                                            self.replica)
                    tickets.append(
                        (i, self.asrv.open_document(op["doc_id"],
                                                    op["tokens"])))
                elif kind == "edit":
                    doc, e = op["doc_id"], op["edit"]
                    if e[0] == "replace":
                        t = self.asrv.submit_replace(doc, e[1], e[2])
                    elif e[0] == "insert":
                        t = self.asrv.submit_insert(doc, e[1], e[2])
                    elif e[0] == "delete":
                        t = self.asrv.submit_delete(doc, e[1])
                    else:
                        raise ValueError(f"unknown edit kind {e[0]!r}")
                    tickets.append((i, t))
                elif kind == "suggest":
                    tickets.append(
                        (i, self.asrv.suggest(op["doc_id"], op["n_new"])))
                elif kind == "tokens":
                    tickets.append((i, self.asrv.tokens(op["doc_id"])))
                elif kind == "ping":
                    results[i] = {"ok": True, "value": {
                        "pid": os.getpid(), "replica": self.replica}}
                elif kind == "barrier":
                    drain()
                    results[i] = {"ok": True, "value": None}
                elif kind == "close":
                    drain()
                    self.asrv.close_document(op["doc_id"]).result(
                        _TICKET_TIMEOUT_S)
                    # a session close retires the document everywhere: any
                    # residual shared-tier snapshot and the lease go with it
                    path = self._cold_path(op["doc_id"])
                    if os.path.exists(path):
                        os.remove(path)
                    cold_tier.release_lease(self.cold_dir, op["doc_id"],
                                            self.replica)
                    results[i] = {"ok": True, "value": None}
                elif kind == "export":
                    drain()
                    path = self._cold_path(op["doc_id"])
                    self.srv.export_document(op["doc_id"], path)
                    cold_tier.release_lease(self.cold_dir, op["doc_id"],
                                            self.replica)
                    results[i] = {"ok": True, "value": path}
                elif kind == "import":
                    drain()
                    cold_tier.acquire_lease(self.cold_dir, op["doc_id"],
                                            self.replica)
                    try:
                        self.srv.import_document(
                            op["doc_id"], self._cold_path(op["doc_id"]),
                            remove=op.get("remove", True))
                    except Exception:
                        cold_tier.release_lease(self.cold_dir, op["doc_id"],
                                                self.replica)
                        raise
                    results[i] = {"ok": True, "value": None}
                elif kind == "checkpoint":
                    drain()
                    doc_ids = op.get("doc_ids") or list(self.srv.docs)
                    for d in doc_ids:
                        self.srv.checkpoint_document(d, self._cold_path(d))
                    results[i] = {"ok": True, "value": list(doc_ids)}
                elif kind == "logits":
                    drain()  # a host numpy copy: picklable
                    results[i] = {"ok": True,
                                  "value": self.srv.logits(op["doc_id"])}
                elif kind == "evict":
                    drain()
                    results[i] = {"ok": True, "value": self.srv.evict(
                        op["doc_id"], op.get("tier", "warm"))}
                elif kind == "stats":
                    drain()
                    results[i] = {"ok": True, "value": self._stats()}
                elif kind == "reset_latency":
                    # benchmark timing protocol: warmup pays the first
                    # launches, then the histograms restart
                    drain()
                    from repro_torch.serving.latency import LatencyStats
                    self.srv.stats.edit_latency = LatencyStats()
                    self.srv.stats.suggest_latency = LatencyStats()
                    results[i] = {"ok": True, "value": None}
                elif kind == "shutdown":
                    drain()
                    self.asrv.close()
                    shutdown = True
                    results[i] = {"ok": True, "value": None}
                else:
                    raise ValueError(f"unknown op {kind!r}")
            except Exception as exc:
                results[i] = _err(exc)
            if shutdown:
                break
        for i, t in tickets:
            results[i] = self._collect(t)
        # ops after a shutdown in the same frame are refused, not dropped
        for i in range(len(ops)):
            if results[i] is None:
                results[i] = _err(RuntimeError("worker is shutting down"))
        return results, not shutdown

    def _collect(self, ticket) -> dict:
        try:
            return {"ok": True, "value": ticket.result(_TICKET_TIMEOUT_S)}
        except Exception as exc:
            return _err(exc)

    def _stats(self) -> dict:
        out = {
            "replica": self.replica,
            "batch": dataclasses.asdict(self.srv.stats),
            "async": dataclasses.asdict(self.asrv.stats),
            "docs_open": len(self.srv.docs),
            "hot_hit_rate": self.srv.stats.hot_hit_rate,
        }
        if self.srv._sugg is not None:
            out["suggest"] = dataclasses.asdict(self.srv.suggest_stats)
        return out


def _err(exc: BaseException) -> dict:
    return {"ok": False, "error": f"{type(exc).__name__}: {exc}",
            "cls": type(exc).__name__}


def main() -> int:
    # Claim the RPC pipe BEFORE anything can print: frames go out on a dup
    # of the original stdout, while fd 1 is redirected to stderr so stray
    # writes (library warnings, user prints) cannot corrupt the framing.
    rpc_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    rpc_in = os.fdopen(os.dup(0), "rb")

    try:
        spec = recv_msg(rpc_in)
        worker = _Worker(spec)
    except Exception as exc:
        traceback.print_exc(file=sys.stderr)
        try:
            send_msg(rpc_out, {"ok": False, "error": str(exc)})
        except Exception:
            pass
        return 1
    send_msg(rpc_out, {"ok": True, "pid": os.getpid(),
                       "replica": worker.replica})
    running = True
    while running:
        try:
            req = recv_msg(rpc_in)
        except EOFError:
            # router gone (or clean stdin close): drain and exit quietly so
            # a crashed router never leaves orphan replicas behind
            try:
                worker.asrv.close()
            except Exception:
                pass
            break
        results, running = worker.handle_frame(req.get("ops", []))
        send_msg(rpc_out, {"id": req.get("id"), "results": results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
