"""Edit sessions: many writers edit their documents at once, in rounds,
through ``BatchServer``'s ``submit_edit`` and ``flush`` (the paper's
incremental loop: the scheduler, the batched engine and ``fused_step``).

A closed loop: a round submits every writer's burst, then flushes; the
next round starts when the flush (ending in a device sync) returns. The
window closes at the end of the first round that ends ``--seconds`` after
it opened, so every edit counted was served in the window and the window
holds all of their time. ``edits_per_s`` is the edits of those rounds over
the window.

``correct`` judges each sampled document's served state once the window
has closed: its tokens and position ids against those the edit stream
gives (``reference.docs``), and every layer's residual stream and VQ codes
against the plain reference run over them with the program's codes
(``reference.vqt.forward``, teacher-forced).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import bench, generate, weights, work
from portbench.reference import docs as refdocs
from portbench.reference import vqt

LIMITS = {"tokens_differ": 0, "positions_differ": 0, "x_err": 5e-5, "code_gap": 1e-3}


def counters(srv) -> dict:
    s = srv.stats
    return {k: getattr(s, k) for k in ("batch_steps", "batched_docs", "overflows",
                                       "edits_applied", "full_forwards", "defrags", "grows")}


class FusedLaunches:
    """Records each ``fused_step`` launch's shapes and live mask entries
    while ``on`` (the traced span), by wrapping the engine's binding of the
    kernel's entry."""

    def __init__(self):
        from repro_torch.serving import jit_engine

        self.mod, self.orig = jit_engine, jit_engine.fused_patch_assign_batched
        self.calls: list = []
        self.on = False

        def wrapped(q, k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias, **kw):
            if self.on:
                self.calls.append((tuple(q.shape), k_new.shape[2], vc_new.shape[-1],
                                   vq_bias.shape[0], mask.sum()))
            return self.orig(q, k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias, **kw)
        jit_engine.fused_patch_assign_batched = wrapped

    def close(self) -> None:
        self.mod.fused_patch_assign_batched = self.orig

    def bound_s(self) -> float:
        total = 0.0
        for (B, n, H, dh), C, Q, hq, live in self.calls:
            total += work.bound_s(*work.fused_step_work(B, n, C, H, dh, Q, hq, float(live)))
        return total


def served(srv, doc_id: str) -> dict:
    """A document's served state in sequence order, on the host."""
    st = srv.state(doc_id)
    n = int(st.n_real)
    key = torch.where(st.valid, st.positions, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)[:n]
    return dict(tokens=st.tokens[order].cpu(), positions=st.positions[order].cpu(),
                x=st.x[:, order].cpu(), codes=st.codes[:, order].cpu())


def expected(texts: list, log: list, pool: int) -> list:
    """Each document after its edits, by the frozen allocation rule."""
    out = []
    for text, edits in zip(texts, log):
        d = refdocs.Document(text, pool)
        for op, pos, tok in edits:
            d.apply(op, pos, tok)
        out.append(d)
    return out


def judge(W: dict, cfg: dict, docs: list, got: dict, device) -> dict:
    """The numbers compared: token and position mismatches, the residual
    stream's largest error relative to the layer's largest entry, the
    largest code gap, and (not compared) the count of codes that differ
    from the reference's own choice."""
    res = dict(tokens_differ=0, positions_differ=0, x_err=0.0, code_gap=0.0, code_flips=0)
    with vqt.precision("float32"), torch.no_grad():
        for i, g in got.items():
            d = docs[i]
            toks = torch.tensor(d.tokens, device=device)
            pos = torch.tensor(d.positions, device=device)
            if len(d.tokens) != len(g["tokens"]):
                res["tokens_differ"] += abs(len(d.tokens) - len(g["tokens"])) + 1
                continue
            res["tokens_differ"] += int((g["tokens"].to(device) != toks).sum())
            res["positions_differ"] += int((g["positions"].to(device) != pos).sum())
            codes = g["codes"].to(device)
            rec = vqt.forward(W, cfg, toks, pos, lambda l: codes[l], keep_x=True)
            xs = g["x"].to(device)
            for l, x_ref in enumerate(rec.xs):
                err = float((xs[l] - x_ref).abs().max() / x_ref.abs().max())
                res["x_err"] = max(res["x_err"], err)
            res["code_gap"] = max(res["code_gap"], rec.gap)
            res["code_flips"] += rec.flips
    return res


def reference_served(W: dict, cfg: dict, docs: list, picked: list, device,
                     kind: str) -> dict:
    """The reference put in the program's place: each document's state by a
    plain forward over its final tokens in precision ``kind`` (the control
    computes it in TF32), in ``served``'s form."""
    got = {}
    with vqt.precision(kind), torch.no_grad():
        for i in picked:
            d = docs[i]
            toks = torch.tensor(d.tokens, device=device)
            pos = torch.tensor(d.positions, device=device)
            rec = vqt.forward(W, cfg, toks, pos, keep_x=True)
            got[i] = dict(tokens=toks.cpu(), positions=pos.cpu(),
                          x=torch.stack(rec.xs).cpu(), codes=torch.stack(rec.codes).cpu())
    return got


def pick(ctx, lengths: list) -> list:
    """The documents checked: the longest, and a seed-drawn sample of the
    rest (``check_docs`` in all)."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    k = min(ctx.traffic["check_docs"], len(lengths)) - 1
    drawn = generate.rng(ctx.seed, 6).choice(rest, k, replace=False)
    return [longest] + sorted(int(i) for i in drawn)


def run(ctx) -> bench.Outcome:
    """One run of the cell."""
    from repro_torch.core.edits import Edit
    from repro_torch.serving.batch_server import BatchServer

    tr, cfg, out = ctx.traffic, ctx.cfg, bench.Outcome()
    W = weights.draw(cfg, ctx.seed, ctx.device)
    # the engine extracts its weight stacks with numpy: it takes host arrays
    srv = BatchServer(weights.to_host(W), bench.arch(cfg), max_batch=tr["max_batch"],
                      use_fused_kernel=True, delta_threshold=tr["delta_threshold"],
                      capacity_class_step=tr["capacity_class_step"], device=ctx.device)
    texts = generate.documents(tr, cfg["vocab"], ctx.seed)
    ids = [f"doc{i}" for i in range(len(texts))]
    srv.open_documents(dict(zip(ids, texts)))
    writers = generate.Writers(tr, [len(t) for t in texts], cfg["vocab"], ctx.seed)
    log: list = [[] for _ in texts]
    meta = dict(d=cfg["d_model"], H=cfg["n_heads"], dh=cfg.get("head_dim") or
                cfg["d_model"] // cfg["n_heads"], Q=cfg["vqt"]["codebook_size"])

    def one_round():
        batch = writers.next_round()
        t0 = ctx.now()
        for w, op, pos, tok, _ in batch:
            srv.submit_edit(ids[w], Edit(op, pos, tok))
            log[w].append((op, pos, tok))
        t1 = ctx.now()
        srv.flush()
        ctx.sync()
        if ctx.trace:
            ctx.spans += [("submit", t0, t1), ("flush", t1, ctx.now())]
        return batch

    for _ in range(tr["warmup_rounds"]):
        one_round()
    launches = FusedLaunches() if ctx.trace else None
    trace = bench.DeviceTrace(ctx).__enter__() if ctx.trace else None
    c0 = counters(srv)
    edits, flops, rounds = 0, 0.0, 0
    t0 = ctx.now()
    out.e2e["setup_s"] = t0 - ctx.t_start
    if launches is not None:
        launches.on = True
    while True:
        batch = one_round()
        rounds += 1
        edits += len(batch)
        flops += sum(work.edit_step_flops(cfg["n_layers"], meta, n, 1, 1, cfg["d_ff"])
                     for *_, n in batch)
        now = ctx.now()
        if trace is not None and now - t0 >= tr["trace_seconds"]:
            launches.on = False
            trace.__exit__(None, None, None)
            out.obs.update(trace=trace.result, paused_s=trace.cost)
            trace = None
        if now - t0 >= ctx.seconds:
            break
    window = ctx.now() - t0
    if trace is not None:
        launches.on = False
        trace.__exit__(None, None, None)
        out.obs["trace"] = trace.result
    c1 = counters(srv)
    out.memory_peak_bytes = ctx.peak_bytes()
    out.attempted = edits
    out.e2e["edits_per_s"] = edits / window
    out.obs.update(window_s=window, rounds=rounds, edits=edits, edit_flops=flops,
                   counters={k: c1[k] - c0[k] for k in c0})
    if launches is not None:
        launches.close()
        tr_res = out.obs["trace"]
        out.obs["fused_step"] = dict(bound_s=launches.bound_s(), calls=len(launches.calls),
                                     kernel=bench.kernel_time(tr_res, "fused_step"))
        out.trace = dict(busy_s=tr_res["busy_s"], window_s=tr_res["window_s"],
                         breakdown=bench.breakdown(tr_res, ctx.spans))
    docs = expected(texts, log, srv.pos_pool)
    picked = pick(ctx, [len(d) for d in docs])
    got = {i: served(srv, ids[i]) for i in picked}
    del srv
    ctx.release()
    res = judge(W, cfg, docs, got, ctx.device)
    for name, lim in LIMITS.items():
        out.check(name, res[name], lim)
    out.obs["judged"] = res
    if ctx.control:
        out.obs["control"] = judge(W, cfg, docs, reference_served(
            W, cfg, docs, picked, ctx.device, ctx.control), ctx.device)
    return out
