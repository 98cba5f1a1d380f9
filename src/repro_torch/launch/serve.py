"""Serving launcher of the port — the demos of ``repro/launch/serve.py``
over ``repro_torch``.

Single-document op-count demo (the paper's measurement; the default mode):
  PYTHONPATH=src python -m repro_torch.launch.serve --doc-len 128 --edits 20

Tiered store (more sessions than the device budget admits; evicted
documents rehydrate bit-exactly on their next touch):
  PYTHONPATH=src python -m repro_torch.launch.serve --tiered --docs 8 \\
      --budget-docs 3 --doc-len 48 --edits 40

Async front end (concurrent sessions through deadline batching; per-edit
and per-suggestion latency printed at the end):
  PYTHONPATH=src python -m repro_torch.launch.serve --async-fleet --docs 4 \\
      --doc-len 48 --edits 24 --delay-ms 8

Replica fleet (subprocess workers behind the document router, with a live
cross-replica migration mid-run):
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 --docs 4 \\
      --doc-len 24 --edits 12

Everything runs on the card (``--device cuda``, the default) at the full
VQ-OPT-125M width; ``--smoke`` takes the reduced config, and ``--device cpu``
runs the plain PyTorch path. Weights are the port's seeded init (seed 0),
or, with ``--ckpt``, a parameter file of either package (``save_pytree``,
e.g. ``repro_torch.examples.distill_vqt``'s) restored into them; fleet
replicas build their own seed-0 weights, as the reference's.
"""
from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.edits import apply_edit, random_atomic_edit
from repro_torch.data import SyntheticCorpus
from repro_torch.models.transformer import init_params


def run_single(args, cfg, params) -> None:
    """One document through the op-counting ``IncrementalServer``: a seeded
    stream of atomic edits, each with its counted ops beside the
    from-scratch cost at the document's new length."""
    from repro_torch.serving.engine import IncrementalServer

    server = IncrementalServer(params, cfg, device=args.device)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    doc = list(corpus.document(args.doc_len, 0))
    server.open_document("doc", doc)
    print(f"opened {len(doc)}-token document; streaming {args.edits} atomic edits")

    rng = np.random.default_rng(0)
    tokens = doc
    for i in range(args.edits):
        e = random_atomic_edit(rng, tokens, cfg.vocab)
        ops = server.apply_edit("doc", e)
        tokens = apply_edit(tokens, e)
        dense = server._dense_ops(len(tokens))
        print(f"edit {i:3d} {e.op:8s}@{e.pos:4d} ops={ops:>14,} "
              f"(from-scratch {dense:>14,} -> {dense / max(ops, 1):6.1f}X)")
    s = server.stats
    print(f"\ntotals: edits={s.edits} defrags={s.defrags} "
          f"cumulative speedup={s.speedup:.1f}X")


def run_tiered(args, cfg, params) -> None:
    """A fleet bigger than the device budget: the batch server's tiered
    state store evicts least-recently-touched sessions to host RAM / disk
    and rehydrates them transparently as the zipf-skewed stream touches
    them again."""
    from repro_torch.common.bucketing import next_pow2
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.jit_engine import state_nbytes_for_config

    # size the budget at the capacity the server will bucket to
    min_cap = next_pow2(max(64, args.doc_len))
    per = state_nbytes_for_config(cfg, min_cap)
    budget = int(args.budget_docs * per * 1.25)
    server = BatchServer(params, cfg, edit_capacity=4, row_capacity=64,
                         max_batch=2, min_doc_capacity=min_cap,
                         device_budget_bytes=budget, host_budget_bytes=2 * per,
                         device=args.device)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    docs = {f"d{i}": list(corpus.document(args.doc_len, i))
            for i in range(args.docs)}
    server.open_documents(docs)
    print(f"opened {args.docs} sessions of ~{per / 2**20:.1f} MiB state under "
          f"a {budget / 2**20:.1f} MiB device budget "
          f"(~{args.budget_docs} resident documents) on {args.device}")

    rng = np.random.default_rng(1)
    w = 1.0 / np.arange(1, args.docs + 1) ** 1.2
    w /= w.sum()
    for i in range(args.edits):
        did = f"d{int(rng.choice(args.docs, p=w))}"
        tier = server.tier(did)
        pos = int(rng.integers(len(server.docs[did].slots)))
        server.submit_replace(did, pos, int(rng.integers(cfg.vocab)))
        server.flush()
        s = server.stats
        print(f"edit {i:3d} -> {did} (was {tier:4s})  tiers "
              f"hot={s.docs_hot} warm={s.docs_warm} cold={s.docs_cold}  "
              f"bytes hot={s.bytes_hot / 2**20:5.1f}MiB "
              f"warm={s.bytes_warm / 2**20:5.1f}MiB "
              f"cold={s.bytes_cold / 2**20:5.1f}MiB")
    s = server.stats
    print(f"\ntotals: edits={s.edits_applied} evictions={s.evictions} "
          f"spills={s.spills} rehydrations={s.rehydrations} "
          f"hot_hit_rate={s.hot_hit_rate:.2f}")
    for did in list(server.docs):
        server.close_document(did)
    print(f"closed all sessions: bytes hot/warm/cold/suggest = "
          f"{s.bytes_hot}/{s.bytes_warm}/{s.bytes_cold}/{s.bytes_suggest}")


def run_async_fleet(args, cfg, params) -> None:
    """Concurrent sessions (one client thread each) through the deadline-
    batching async front end: each client types a burst of edits, then
    blocks on its refreshed suggestion; bursts admitted within one
    ``--delay-ms`` window share dispatch rounds."""
    from repro_torch.serving.async_server import AsyncBatchServer
    from repro_torch.serving.batch_server import BatchServer

    server = BatchServer(params, cfg, edit_capacity=4, row_capacity=32,
                         max_batch=max(2, args.docs), min_doc_capacity=64,
                         device=args.device)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    docs = {f"d{i}": list(corpus.document(args.doc_len, i))
            for i in range(args.docs)}

    def client(asrv, did, seed):
        rng = np.random.default_rng(seed)
        tokens = list(docs[did])
        for burst in range(args.edits // 3):
            for _ in range(3):
                e = random_atomic_edit(rng, tokens, cfg.vocab)
                asrv.submit_edit(did, e)
                tokens = apply_edit(tokens, e)
            sugg = asrv.suggest(did, 8).result(600)
            print(f"  {did} burst {burst}: suggestion "
                  f"{[int(x) for x in sugg[:4]]}...")

    with AsyncBatchServer(server, max_batch_delay_ms=args.delay_ms) as asrv:
        for t in [asrv.open_document(d, toks) for d, toks in docs.items()]:
            t.result(600)
        print(f"opened {args.docs} concurrent sessions on {args.device} "
              f"(deadline {args.delay_ms}ms, bucket {asrv.bucket_docs} docs)")
        threads = [threading.Thread(target=client, args=(asrv, d, 10 + i))
                   for i, d in enumerate(docs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        a = asrv.stats
        print(f"\nrounds={a.rounds} (deadline={a.deadline_rounds} "
              f"full={a.full_rounds}) mean_edits_per_round="
              f"{a.mean_edits_per_round:.2f} failed={a.requests_failed}")
    s = server.stats
    for name, h in (("edit", s.edit_latency), ("suggest", s.suggest_latency)):
        print(f"{name:8s} latency: n={h.count} p50={h.p50:.1f}ms "
              f"p99={h.p99:.1f}ms max={h.max_ms:.1f}ms")


def run_fleet(args, cfg) -> None:
    """Replica workers behind the document router: sessions spread across
    subprocess replicas by load, one document live-migrates through the
    shared cold tier mid-run, and the router's aggregated stats print as a
    table. Workers build their own weights (same seed, bitwise-equal)."""
    from repro_torch.serving.fleet import FleetRouter

    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    docs = {f"d{i}": [int(t) for t in corpus.document(args.doc_len, i)]
            for i in range(args.docs)}
    rng = np.random.default_rng(2)
    with FleetRouter(args.fleet, arch=args.arch, smoke=args.smoke,
                     max_batch_delay_ms=args.delay_ms,
                     device=args.device) as fleet:
        print(f"booted {args.fleet} replica workers on {args.device} "
              f"(shared cold tier: {fleet.cold_dir})")
        for t in [fleet.open_document(d, toks) for d, toks in docs.items()]:
            t.result(600)
        placement = {d: fleet.owner_of(d) for d in docs}
        print("placement: " + "  ".join(
            f"{d}->r{r}" for d, r in sorted(placement.items())))
        for i in range(args.edits):
            did = f"d{int(rng.integers(args.docs))}"
            if i == args.edits // 2 and args.fleet > 1:
                dst = (fleet.owner_of(did) + 1) % args.fleet
                fleet.migrate(did, dst)
                print(f"edit {i:3d}: migrated {did} -> r{dst} "
                      "(bit-exact, via the shared cold tier)")
            toks = fleet.tokens(did).result(600)
            pos = int(rng.integers(len(toks)))
            fleet.submit_replace(did, pos,
                                 int(rng.integers(cfg.vocab))).result(600)
        sugg = fleet.suggest(did, 8).result(600)
        print(f"last suggestion for {did}: {[int(x) for x in sugg[:4]]}...")
        agg = fleet.stats(600)
        print("\nfleet totals:")
        rows = [("replicas alive", agg["replicas_alive"]),
                ("worker boot s", " / ".join(f"{b:.1f}" for b in agg["boot_s"])),
                ("documents open", agg["docs_open"]),
                ("edits applied", agg["edits_applied"]),
                ("rounds (deadline)",
                 f"{agg['rounds']} ({agg['deadline_rounds']})"),
                ("migrations", agg["router"]["migrations"]),
                ("hot-hit rate", f"{agg['hot_hit_rate']:.2f}"),
                ("edit p50/p99 ms",
                 f"{agg['edit_latency']['p50_ms']:.1f} / "
                 f"{agg['edit_latency']['p99_ms']:.1f}"),
                ("suggest p50/p99 ms",
                 f"{agg['suggest_latency']['p50_ms']:.1f} / "
                 f"{agg['suggest_latency']['p99_ms']:.1f}")]
        for s in agg["per_replica"]:
            rows.append((f"{s['replica']} edits/docs",
                         f"{s['batch']['edits_applied']}/{s['docs_open']}"))
        width = max(len(k) for k, _ in rows)
        for k, v in rows:
            print(f"  {k:<{width}}  {v}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="vq-opt-125m")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (still on --device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--doc-len", type=int, default=128)
    ap.add_argument("--edits", type=int, default=20)
    ap.add_argument("--ckpt", default=None,
                    help="a parameter file (save_pytree) to serve instead of the "
                         "seed-0 weights")
    ap.add_argument("--tiered", action="store_true",
                    help="multi-session fleet under a device-memory budget")
    ap.add_argument("--docs", type=int, default=8,
                    help="(--tiered/--async-fleet/--fleet) sessions to open")
    ap.add_argument("--budget-docs", type=int, default=3,
                    help="(--tiered) device budget, in resident documents")
    ap.add_argument("--async-fleet", action="store_true",
                    help="concurrent sessions via the deadline-batching "
                         "async front end")
    ap.add_argument("--delay-ms", type=float, default=8.0,
                    help="(--async-fleet/--fleet) max_batch_delay_ms "
                         "dispatch deadline")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve through N subprocess replica workers behind "
                         "the document router")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.fleet:
        run_fleet(args, cfg)  # replicas build their own weights (same seed)
        return
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    if args.ckpt:
        from repro_torch.checkpoint import restore_pytree

        params = restore_pytree(args.ckpt, params)
    if args.tiered:
        run_tiered(args, cfg, params)
    elif args.async_fleet:
        run_async_fleet(args, cfg, params)
    else:
        run_single(args, cfg, params)


if __name__ == "__main__":
    main()
