"""Multi-tenant writing-assistant demo: many users edit their documents
concurrently — replacing, INSERTING and DELETING tokens — the batch server
serves every pending edit with capacity-bucketed batched dispatches, and a
subset of users keep a SUGGESTION subscription open: after each tick the
server refreshes their greedy continuations, reusing every decode-cache row
before the earliest edited position instead of re-prefilling the document.

    PYTHONPATH=src python -m repro_torch.examples.incremental_serving [--device cpu]

The port's counterpart of ``examples/incremental_serving.py``, on
``--device`` (default ``cuda``) at the reduced config, with the port's
seeded weights; it asserts the same: every token buffer equals its
edit-replayed reference and every subscription holds a suggestion.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.models.transformer import init_params
from repro_torch.serving.batch_server import BatchServer
from repro_torch.serving.engine import IncrementalServer

N_DOCS = 12
N_SUGGEST = 4


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_config("vq-opt-125m", smoke=True)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(0)

    # ---- open a fleet of documents ---------------------------------------
    server = BatchServer(params, cfg, edit_capacity=4, row_capacity=32,
                         max_batch=8, min_doc_capacity=64, device=args.device)
    docs = {}
    for i in range(N_DOCS):
        n = int(rng.integers(48, 100))  # mixed lengths -> multiple n_cap buckets
        docs[f"user{i}"] = list(corpus.document(n, i))
    server.open_documents(docs)  # same-bucket docs share one ingest dispatch
    print(f"opened {N_DOCS} documents via batched ingest on {args.device} "
          f"({server.stats.traced_shapes} step shapes)")

    # a subset of writers keeps live suggestions open (the assistant pane)
    for i in range(N_SUGGEST):
        server.submit_suggest(f"user{i}", n_new=6)

    # ---- simulate edit traffic --------------------------------------------
    # Each tick, a random subset of users edits: ~45% replaces, ~35% inserts,
    # ~20% deletes. The scheduler translates sequence positions to slots,
    # groups pending edits into typed (n_cap, C, R, op) buckets, and serves
    # each bucket with ONE batched step.
    print("\ntraffic: 6 ticks of concurrent mixed edits")
    for tick in range(6):
        n_active = int(rng.integers(3, N_DOCS + 1))
        for uid in rng.choice(N_DOCS, n_active, replace=False):
            doc_id = f"user{uid}"
            ref = docs[doc_id]
            for _ in range(int(rng.integers(1, 4))):
                op = rng.choice(["replace", "insert", "delete"], p=[0.45, 0.35, 0.20])
                if op == "replace":
                    pos = int(rng.integers(len(ref)))
                    tok = int(rng.integers(cfg.vocab))
                    server.submit_replace(doc_id, pos, tok)
                    ref[pos] = tok
                elif op == "insert":
                    pos = int(rng.integers(len(ref) + 1))
                    tok = int(rng.integers(cfg.vocab))
                    server.submit_insert(doc_id, pos, tok)
                    ref.insert(pos, tok)
                elif len(ref) > 1:
                    pos = int(rng.integers(len(ref)))
                    server.submit_delete(doc_id, pos)
                    del ref[pos]
        pending = server.pending_count()
        applied = server.flush()  # edits apply, then stale suggestions refresh
        s = server.stats
        print(f"  tick {tick}: {pending:2d} pending -> {applied:2d} applied in "
              f"{s.batch_steps} total dispatches "
              f"(mean batch {s.mean_batch:.1f}, overflows {s.overflows}, "
              f"defrags {s.defrags}, grows {s.grows}); "
              f"suggestions: {s.suggest_refreshes} refreshes, "
              f"{s.suggest_invalidations} invalidated by newer edits")

    # ---- verify + inspect -------------------------------------------------
    for doc_id, ref in docs.items():
        assert list(server.tokens(doc_id)) == ref, doc_id
    logits = server.logits("user0")
    s = server.stats
    print(f"\nall {N_DOCS} token buffers match the edit-replayed references "
          f"(lengths changed under inserts/deletes: "
          f"{[len(docs[f'user{i}']) for i in range(4)]}...)")
    print(f"logits('user0'): shape {logits.shape}, argmax token {int(logits.argmax())}")
    print(f"server totals: {s.edits_applied} edits in {s.batch_steps} batched "
          f"dispatches (mean batch {s.mean_batch:.1f}), {s.overflows} overflows, "
          f"{s.defrags} defrags, {s.grows} grows, "
          f"{s.full_forwards} full forwards, {s.traced_shapes} step shapes")

    # ---- the assistant pane: fresh suggestions with prefix reuse ----------
    for i in range(N_SUGGEST):
        sug = server.suggestion(f"user{i}")
        assert sug is not None  # flush refreshed every stale subscription
        print(f"  user{i} suggestion: {[int(t) for t in sug]}")
    ss = server.suggest_stats
    print(f"suggestion serving: {ss.refreshes} refreshes reused "
          f"{ss.prefill_rows_reused}/{ss.prefill_rows_total} prefill rows "
          f"({100 * ss.reused_fraction:.0f}% — a from-scratch assistant would "
          f"re-prefill every row every time), {ss.decode_steps} decode steps")

    # ---- op-count view (the paper's metric, single-worker server) ---------
    # The op-counting IncrementalServer meters arithmetic ops; one quick
    # revision shows the per-request saving the batch above is built on.
    op_server = IncrementalServer(params, cfg, device=args.device)
    base = list(corpus.document(256, 999))
    op_server.open_document("doc", base)
    new = list(base)
    for pos in sorted(rng.choice(256, 3, replace=False), reverse=True):
        new[int(pos)] = int(rng.integers(cfg.vocab))
    new.insert(128, int(rng.integers(cfg.vocab)))  # a structural edit too
    del new[40]
    ops = op_server.submit_revision("doc", new)
    assert list(op_server.tokens("doc")) == new
    dense = op_server._dense_ops(len(new))
    print(f"\nop-count view: a 5-edit revision (replaces+insert+delete) of a "
          f"256-token doc costs {dense / max(ops, 1):.1f}X less than "
          f"recompute-from-scratch")


if __name__ == "__main__":
    main()
