"""The writing assistant: every writer keeps a standing suggestion
(``submit_suggest``) while it edits, and each round's ``flush`` applies
the edits and refreshes the stale suggestions (the KV export, the
re-prefill from the earliest edited position and the greedy decode).

A closed loop of rounds as in the edit cell. The writers read their
suggestions as they stream (``on_suggest_token``): a writer's sample is
the time from its round's start, before the edits are submitted, to the
last token of its refreshed suggestion, read on the host.
``suggest_p90_ms`` is the 90th percentile of every (writer, round)
sample of the rounds served in the window.

``correct`` judges a seed-drawn sample of the suggestions served in the
window, the longest document's among them, once the window has closed:
the plain reference runs over each prompt (worked out from the edit
stream) with the served tokens, and each served token is read by how far
its logit lies below the reference's best at its position. One VQ near
tie that the program's float order resolves the other way moves a row's
logits by a code's difference, so the widest gap (recorded) reads like a
wrong token on a seed where nothing is wrong (PERF.md). Two numbers are
compared: the share of tokens off by more than ``TIE``, and the share of
tokens off in suggestions that no single near tie explains: where taking
one of the reference's near ties (a lead within ``NEAR``) the other way
puts every token of the suggestion within ``TIE`` of the best, its tokens
off are explained.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import bench, generate, weights
from portbench.reference import docs as refdocs
from portbench.reference import vqt

# a served token is off when its logit lies this far below the reference's
# best: two float32 orders of the same logits differ by ~1e-5
TIE = 1e-3
# a VQ choice whose lead over the runner-up is within this is a near tie
# that the program's float order may take the other way: the edit cell's
# limit on how far a served code may score below the reference's best
NEAR = 1e-3
# the near ties tried a suggestion, narrowest first
TRIES = 16
LIMITS = {"tokens_off": 3.0, "tokens_unexplained": 1.0}


def judge(W: dict, cfg: dict, samples: list, device, kind: str | None = None) -> dict:
    """Each judged token's gap below the reference's best logit at its
    position, over the samples (tokens, positions, served). The judged
    token is the served one, or with ``kind`` the one the reference
    computed in precision ``kind`` puts first there (the control).
    Returns the share of tokens off by more than ``TIE`` and the share of
    those in suggestions that no near tie explains (%, both compared), the
    widest gap, and for each suggestion with a token off the lead of the
    near tie that explains it, or None."""
    gaps, ties, unexplained = [], [], 0
    for toks, pos, served in samples:
        n, m = len(toks), len(served)
        t = torch.tensor(list(toks) + list(served), device=device)
        p = torch.tensor(list(pos) + [pos[-1] + 1 + i for i in range(m)], device=device)
        with torch.no_grad():
            with vqt.precision("float32"):
                rec = vqt.forward(W, cfg, t, p, near=NEAR)
                lg = vqt.logits(W, cfg, rec.xs[-1][n - 1:n - 1 + m])
            if kind is None:
                pickd = torch.tensor(served, device=device).long()
            else:
                with vqt.precision(kind):
                    ctl = vqt.forward(W, cfg, t, p).xs[-1][n - 1:n - 1 + m]
                    pickd = vqt.logits(W, cfg, ctl).argmax(-1)
            gap = gaps_of(lg, pickd)
            gaps += gap.tolist()
            if gap.max() > TIE:
                lead = explained(W, cfg, t, p, n, m, pickd, rec)
                ties.append(lead)
                unexplained += 0 if lead is not None else int((gap > TIE).sum())
    off = sum(g > TIE for g in gaps)
    share = lambda k: 100.0 * k / max(len(gaps), 1)  # noqa: E731
    return dict(tokens_off=share(off), tokens_unexplained=share(unexplained),
                token_gap=max(gaps, default=0.0), tokens=len(gaps), off=off,
                unexplained=unexplained, tie_leads=ties)


def gaps_of(lg: torch.Tensor, pickd: torch.Tensor) -> torch.Tensor:
    """How far each picked token's logit lies below the best at its row."""
    return lg.max(-1).values - torch.gather(lg, -1, pickd[:, None])[:, 0]


def explained(W: dict, cfg: dict, t, p, n: int, m: int, pickd, rec):
    """The lead of the first of the reference's near ties (``rec.ties``,
    narrowest first, in rows that the judged logits see) that, taken the
    other way with every later choice the reference's own, puts each
    picked token within ``TIE`` of the best; None where none does."""
    for lead, l, r, h, alt in sorted(x for x in rec.ties if x[2] < n - 1 + m)[:TRIES]:
        flipped = rec.codes[l].clone()
        flipped[r, h] = alt
        with vqt.precision("float32"):
            x = vqt.forward(W, cfg, t, p, lambda j: flipped if j == l else None).xs[-1]
            if gaps_of(vqt.logits(W, cfg, x[n - 1:n - 1 + m]), pickd).max() <= TIE:
                return lead
    return None


def run(ctx) -> bench.Outcome:
    from repro_torch.core.edits import Edit
    from repro_torch.serving.batch_server import BatchServer

    tr, cfg, out = ctx.traffic, ctx.cfg, bench.Outcome()
    W = weights.draw(cfg, ctx.seed, ctx.device)
    srv = BatchServer(weights.to_host(W), bench.arch(cfg), max_batch=tr["max_batch"],
                      use_fused_kernel=True, delta_threshold=tr["delta_threshold"],
                      capacity_class_step=tr["capacity_class_step"], device=ctx.device)
    texts = generate.documents(tr, cfg["vocab"], ctx.seed)
    ids = [f"doc{i}" for i in range(len(texts))]
    index = {d: i for i, d in enumerate(ids)}
    srv.open_documents(dict(zip(ids, texts)))
    n_new = tr["n_new"]
    ready: dict = {}  # writer -> time its suggestion's last token was read
    streamed: dict = {}

    def on_token(doc_id, serial, _tok):
        k = (doc_id, serial)
        streamed[k] = streamed.get(k, 0) + 1
        if streamed[k] == n_new:
            ready[index[doc_id]] = ctx.now()
    srv.on_suggest_token = on_token
    for d in ids:
        srv.submit_suggest(d, n_new)
    srv.flush()
    ctx.sync()
    writers = generate.Writers(tr, [len(t) for t in texts], cfg["vocab"], ctx.seed)
    log: list = [[] for _ in texts]
    served: list = []  # (round, writer, suggestion)

    def one_round(r):
        batch = writers.next_round()
        ready.clear()
        t0 = ctx.now()
        for w, op, pos, tok, _ in batch:
            srv.submit_edit(ids[w], Edit(op, pos, tok))
            log[w].append((r, op, pos, tok))
        t1 = ctx.now()
        srv.flush()
        ctx.sync()
        if ctx.trace:
            ctx.spans += [("submit", t0, t1), ("flush", t1, ctx.now())]
        for w, d in enumerate(ids):
            s = srv.suggestion(d)
            if s is not None:
                served.append((r, w, [int(x) for x in s]))
        return [(ready[w] - t0) * 1e3 for w in sorted(ready)]

    r = 0
    for _ in range(tr["warmup_rounds"]):
        one_round(r)
        r += 1
    first_window_round = r
    s0 = srv.suggest_stats
    rows0 = (s0.prefill_rows_reused, s0.prefill_rows_recomputed)
    trace = bench.DeviceTrace(ctx).__enter__() if ctx.trace else None
    samples: list = []
    t0 = ctx.now()
    out.e2e["setup_s"] = t0 - ctx.t_start
    while True:
        samples += one_round(r)
        r += 1
        now = ctx.now()
        if trace is not None and now - t0 >= min(tr["trace_seconds"], ctx.seconds):
            trace.__exit__(None, None, None)
            out.obs["trace"], trace = trace.result, None
        if now - t0 >= ctx.seconds:
            break
    window = ctx.now() - t0
    s1 = srv.suggest_stats
    out.memory_peak_bytes = ctx.peak_bytes()
    out.attempted = len(samples)
    out.e2e["suggest_p90_ms"] = float(np.percentile(samples, 90))
    out.obs.update(window_s=window, rounds=r - first_window_round, samples=len(samples),
                   counters=dict(rows_reused=s1.prefill_rows_reused - rows0[0],
                                 rows_recomputed=s1.prefill_rows_recomputed - rows0[1]))
    if "trace" in out.obs:
        t = out.obs["trace"]
        out.trace = dict(busy_s=t["busy_s"], window_s=t["window_s"],
                         breakdown=bench.breakdown(t, ctx.spans))
    del srv
    ctx.release()
    judged = [x for x in served if x[0] >= first_window_round]
    checks = pick(ctx, judged, prompts(texts, log, cfg, n_new, r))
    res = judge(W, cfg, checks, ctx.device)
    for name, lim in LIMITS.items():
        out.check(name, res[name], lim)
    out.obs["judged"] = dict(res, suggestions=len(checks))
    if ctx.control:
        out.obs["control"] = judge(W, cfg, checks, ctx.device, kind=ctx.control)
    return out


def prompts(texts: list, log: list, cfg: dict, n_new: int, rounds: int) -> dict:
    """(round, writer) -> (tokens, positions) each suggestion was served
    over, worked out from the edit stream: a writer's edits of the round,
    then the re-spread a continuation past the pool's end forces."""
    pool = cfg.get("pos_pool") or cfg["max_seq"]
    out = {}
    for w, text in enumerate(texts):
        d = refdocs.Document(text, pool)
        d.headroom(n_new)
        edits = iter(log[w])
        pending = next(edits, None)
        for r in range(rounds):
            while pending is not None and pending[0] == r:
                d.apply(*pending[1:])
                pending = next(edits, None)
            d.headroom(n_new)
            out[(r, w)] = (list(d.tokens), list(d.positions))
    return out


def pick(ctx, judged: list, docs_at: dict) -> list:
    """A seed-drawn sample of ``check_suggestions`` served suggestions, the
    one over the longest prompt among them: (tokens, positions, served)."""
    if not judged:
        return []
    longest = max(range(len(judged)), key=lambda i: len(docs_at[judged[i][:2]][0]))
    rest = [i for i in range(len(judged)) if i != longest]
    k = min(ctx.traffic["check_suggestions"], len(judged)) - 1
    chosen = [longest] + [int(i) for i in generate.rng(ctx.seed, 9).choice(rest, k, replace=False)]
    return [(*docs_at[judged[i][:2]], judged[i][2]) for i in sorted(chosen)]
