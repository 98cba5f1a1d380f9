"""Documents ingested: batches of equal-length documents prefilled into
fresh KV caches with ``prefill_step``, in chunks (the dense path every
served document takes: the GEMMs, σ attention against the cache, and
``vq_assign``; the incremental engine is bypassed).

Batches follow each other back to back; the lengths cycle through the
mix's list in its order (the seed draws the weights and tokens). The window closes at the end of
the first chunk that ends ``--seconds`` after it opened;
``prefill_tokens_per_s`` is the tokens of the chunks served in it over
the window.

``correct`` judges the sampled batches once the window has closed (the
longest of the first cycle and a seed-drawn other; one still running when
the window closes is finished first): the last row's logits of each
sequence and the keys and values every layer wrote to its cache, against
the plain reference run over the same tokens with the program's VQ codes,
and each code's gap below the reference's best. The caches of a judged
batch stay on the card until then, which no deployment does:
``memory_peak_bytes`` leaves their bytes out.
"""
from __future__ import annotations

import torch

from portbench import bench, generate, weights, work
from portbench.reference import vqt

LIMITS = {"logits_err": 1e-4, "cache_err": 1e-4, "code_gap": 2e-3}


class CodeTap:
    """Keeps the codes ``vq_assign`` returns while ``on`` (the sampled
    batches), and each call's rows while ``shapes`` is on (the traced span),
    by wrapping the binding that ``core.vq.quantize`` calls."""

    def __init__(self):
        from repro_torch.core import vq

        self.mod, self.orig = vq, vq.vq_assign
        self.codes: list = []
        self.calls: list = []
        self.on = self.shapes = False

        def wrapped(x, codebook):
            idx, xq = self.orig(x, codebook)
            if self.on:
                self.codes.append(idx)
            if self.shapes:
                self.calls.append((x.numel() // x.shape[-1], *codebook.shape))
            return idx, xq
        vq.vq_assign = wrapped

    def close(self) -> None:
        self.mod.vq_assign = self.orig

    def bound_s(self) -> float:
        return sum(work.bound_s(*work.vq_assign_work(M, hq, Q, dv)) for M, hq, Q, dv in self.calls)


def batch_tokens(ctx, index: int, length: int):
    g = torch.Generator(device=ctx.device).manual_seed(
        int(generate.rng(ctx.seed, 7, index).integers(0, 1 << 62)))
    return torch.randint(0, ctx.cfg["vocab"], (ctx.traffic["batch"], length), generator=g,
                         device=ctx.device, dtype=torch.int64).to(torch.int32)


def judge(W: dict, cfg: dict, kept: list, device) -> dict:
    """``kept``: per checked batch (tokens [B, n], last logits [B, V], the
    caches' keys and values [L, B, n, Hkv, dh], codes [L, B, n, hq])."""
    res = dict(logits_err=0.0, cache_err=0.0, code_gap=0.0, code_flips=0)
    with vqt.precision("float32"), torch.no_grad():
        for toks, last, k, v, codes in kept:
            n = toks.shape[1]
            pos = torch.arange(n, device=device)
            for b in range(toks.shape[0]):
                rec = vqt.forward(W, cfg, toks[b].to(device), pos,
                                  lambda l: codes[l, b].to(device), keep_kv=True)
                lg = vqt.logits(W, cfg, rec.xs[-1][-1:])[0]
                res["logits_err"] = max(res["logits_err"], float(
                    (last[b].to(device) - lg).abs().max() / lg.abs().max()))
                for l in range(cfg["n_layers"]):
                    for got, want in ((k[l, b], rec.ks[l]), (v[l, b], rec.vs[l])):
                        res["cache_err"] = max(res["cache_err"], float(
                            (got.to(device) - want).abs().max() / want.abs().max()))
                res["code_gap"] = max(res["code_gap"], rec.gap)
                res["code_flips"] += rec.flips
                del rec
    return res


def reference_kept(W: dict, cfg: dict, toks: torch.Tensor, kind: str) -> tuple:
    """The reference put in the program's place for one batch, in precision
    ``kind`` (the control computes it in TF32): the tuple ``judge`` reads."""
    recs = []
    with vqt.precision(kind), torch.no_grad():
        for b in range(toks.shape[0]):
            pos = torch.arange(toks.shape[1], device=toks.device)
            rec = vqt.forward(W, cfg, toks[b], pos, keep_kv=True)
            recs.append((vqt.logits(W, cfg, rec.xs[-1][-1:])[0], rec.ks, rec.vs, rec.codes))
    st = lambda i: torch.stack([torch.stack(r[i]) for r in recs], dim=1)  # noqa: E731
    return toks, torch.stack([r[0] for r in recs]), st(1), st(2), st(3)


def run(ctx) -> bench.Outcome:
    from repro_torch.models import transformer as T

    tr, cfg, out = ctx.traffic, ctx.cfg, bench.Outcome()
    W = weights.draw(cfg, ctx.seed, ctx.device)
    acfg = bench.arch(cfg)
    B, chunk = tr["batch"], tr["chunk"]
    lengths = generate.prefill_batches(tr, 10_000)
    cycle = len(tr["lengths"])
    first = lengths[:cycle]
    longest = max(range(cycle), key=lambda i: first[i])
    others = [i for i in range(cycle) if i != longest]
    g = generate.rng(ctx.seed, 8)
    checked = sorted({longest, *(int(i) for i in g.choice(others, tr["check_batches"] - 1,
                                                           replace=False))})
    tap = CodeTap()

    def prefill(toks, caches, c0):
        pos = torch.arange(c0, c0 + chunk, device=ctx.device, dtype=torch.int32).expand(B, chunk)
        return T.prefill_step(W, acfg, toks[:, c0:c0 + chunk], caches, pos)

    # warm-up: one chunk into caches of every length the mix uses
    for n in sorted(set(tr["lengths"])):
        prefill(batch_tokens(ctx, 1 << 30, n), T.init_caches(acfg, B, n, device=ctx.device), 0)
    ctx.sync()
    kept, tokens_done, flops = [], 0, 0.0
    # bytes the kept batches hold for the judge, and the peak without them
    # before the last reset of the card's peak
    held, peak = 0, 0
    index, c0, toks, caches, logits = 0, 0, None, None, None
    trace = bench.DeviceTrace(ctx).__enter__() if ctx.trace else None
    tap.shapes = trace is not None
    t0 = ctx.now()
    out.e2e["setup_s"] = t0 - ctx.t_start
    window = None
    while window is None or len(kept) < len(checked):
        if c0 == 0:
            n = lengths[index]
            caches = logits = None  # the last batch's, done with
            toks = batch_tokens(ctx, index, n)
            caches = T.init_caches(acfg, B, n, device=ctx.device)
            tap.on = index in checked
        t_c, start = ctx.now(), c0
        logits, caches = prefill(toks, caches, start)
        c0 += chunk
        if c0 >= toks.shape[1]:
            if tap.on:
                L = cfg["n_layers"]
                per_layer = [torch.cat(tap.codes[l::L], dim=1) for l in range(L)]
                peak = max(peak, ctx.peak_bytes() - held)
                ctx.reset_peak()
                kept.append((toks, logits[:, -1].clone(), caches[0][0]["mix"]["k"],
                             caches[0][0]["mix"]["v"], torch.stack(per_layer)))
                held += sum(t.numel() * t.element_size() for t in kept[-1])
                tap.codes, tap.on = [], False
            index, c0 = index + 1, 0
        ctx.sync()
        now = ctx.now()
        if ctx.trace:
            ctx.spans.append(("prefill_step", t_c, now))
        if window is not None:
            continue  # finishing a checked batch after the window
        tokens_done += B * chunk
        flops += work.forward_flops(
            cfg, B * chunk, B * (work.causal_pairs(start + chunk, start + chunk)
                                 - work.causal_pairs(start, start)), B * chunk)
        if trace is not None and now - t0 >= min(tr["trace_seconds"], ctx.seconds):
            trace.__exit__(None, None, None)
            out.obs.update(trace=trace.result, paused_s=trace.cost)
            trace, tap.shapes = None, False
            now = ctx.now()
        if now - t0 >= ctx.seconds:
            window = now - t0
            out.memory_peak_bytes = max(peak, ctx.peak_bytes() - held)
    out.attempted = tokens_done
    out.e2e["prefill_tokens_per_s"] = tokens_done / window
    out.obs.update(window_s=window, prefill_flops=flops, tokens=tokens_done, batches=index)
    if "trace" in out.obs:
        tr_res = out.obs["trace"]
        out.obs["vq_assign"] = dict(bound_s=tap.bound_s(), calls=len(tap.calls),
                                    kernel=bench.kernel_time(tr_res, "vq_assign"))
        out.trace = dict(busy_s=tr_res["busy_s"], window_s=tr_res["window_s"],
                         breakdown=bench.breakdown(tr_res, ctx.spans))
    tap.close()
    del caches, logits, toks
    ctx.release()
    res = judge(W, cfg, kept, ctx.device)
    for name, lim in LIMITS.items():
        out.check(name, res[name], lim)
    out.obs["judged"] = res
    if ctx.control:
        out.obs["control"] = judge(W, cfg, [reference_kept(W, cfg, k[0], ctx.control)
                                            for k in kept], ctx.device)
    return out
