"""Every device-to-host sync on the edit and suggestion paths, by the line
that makes it.

    python3 tools/sync_census.py --workload vq-opt-125m.edits --seed 5 [--rounds 1]

Builds the serving cell of ``BENCHMARK.json`` as its driver does (the
configuration, the seeded weights, documents and writers of
``portbench/``), serves the mix's warm-up rounds, then serves ``--rounds``
more under ``torch.cuda.set_sync_debug_mode("warn")``. Each sync warning
is tallied by the innermost frame under ``src/repro_torch/`` and the
innermost host span open there (``repro_torch.serving.spans``), and
counted a dispatch (``BatchStats.batch_steps``) and a refresh
(``suggest_refreshes``) of those rounds. The line also gives the spans the
last warm-up round recorded and its seconds (``warm``), the cell's spans a
second. Prints one JSON line; needs a card, since the debug mode watches
CUDA streams.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import bench, generate, weights  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    bench.setup_env()
    import torch

    from repro_torch.core.edits import Edit
    from repro_torch.serving import spans
    from repro_torch.serving.batch_server import BatchServer

    if not torch.cuda.is_available():
        print("sync_census: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    spec = bench.cell(args.workload)
    cfg, tr = spec["config"], spec["traffic"]
    W = weights.draw(cfg, args.seed, "cuda")
    srv = BatchServer(weights.to_host(W), bench.arch(cfg), max_batch=tr["max_batch"],
                      use_fused_kernel=True, delta_threshold=tr["delta_threshold"],
                      capacity_class_step=tr["capacity_class_step"], device="cuda")
    texts = generate.documents(tr, cfg["vocab"], args.seed)
    ids = [f"doc{i}" for i in range(len(texts))]
    srv.open_documents(dict(zip(ids, texts)))
    if "n_new" in tr:  # the assist mix: standing suggestions, streamed
        srv.on_suggest_token = lambda *_: None
        for d in ids:
            srv.submit_suggest(d, tr["n_new"])
        srv.flush()
    writers = generate.Writers(tr, [len(t) for t in texts], cfg["vocab"], args.seed)

    def one_round():
        for w, op, pos, tok, _ in writers.next_round():
            srv.submit_edit(ids[w], Edit(op, pos, tok))
        srv.flush()
        torch.cuda.synchronize()

    ring = spans.RING
    for _ in range(tr["warmup_rounds"]):
        t0 = time.perf_counter()
        one_round()
    # the last warm-up round, served as the cell serves it: spans a second
    t1 = time.perf_counter()
    warm = dict(spans=len(spans.between(t0, t1)), seconds=t1 - t0)
    tally, code = Counter(), {}

    def show(message, category, filename, lineno, file=None, line=None):
        mine = [f for f in traceback.extract_stack()[:-1] if "/src/repro_torch/" in f.filename]
        where = (f"{mine[-1].filename.split('/src/')[-1]}:{mine[-1].lineno}" if mine
                 else f"{filename}:{lineno}")
        stack = ring._stack()
        tally[(where, ring._name[stack[-1] % ring.capacity] if stack else "-")] += 1
        code.setdefault(where, mine[-1].line if mine else str(message)[:80])

    s0 = (srv.stats.batch_steps, srv.stats.suggest_refreshes)
    with warnings.catch_warnings():  # restores showwarning on the way out
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(args.rounds):
                one_round()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    dispatches = srv.stats.batch_steps - s0[0]
    refreshes = srv.stats.suggest_refreshes - s0[1]
    rows = [dict(where=w, span=s, count=n, code=code[w],
                 per_dispatch=n / dispatches if dispatches else None,
                 per_refresh=n / refreshes if refreshes else None)
            for (w, s), n in tally.most_common()]
    print(json.dumps(dict(workload=args.workload, seed=args.seed, rounds=args.rounds,
                          dispatches=dispatches, refreshes=refreshes, warm=warm,
                          device=torch.cuda.get_device_name(0), power=bench.power_limit(),
                          syncs=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
