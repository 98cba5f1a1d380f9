"""Adapting the model: ``make_train_step`` steps (the LM loss with the
Gumbel straight-through VQ, the σ attention backward kernels, AdamW) on
seeded batches of distinct rows, back to back; serving is bypassed.

Set-up builds one training state from the benchmark's weights and drives
it through the first ``checked_steps`` steps by the window's own call and
feed; the window then continues the same state. ``train_tokens_per_s`` is
the tokens of the steps completed in the window over the window (each step
ends in a sync).

``correct`` holds those first steps against the plain reference's
(``reference.vqt.train_steps``) on the same weights, batches and Gumbel
noise: the losses of the first two steps (every step's is recorded); the
first gradient as the optimizer took it
(its first moment after one step over 1 − b1), by the worst leaf's norm;
and the parameters' change after the checked steps, by the worst leaf's
norm. A leaf's gap is measured against the larger of its reference norm
and the median leaf's; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""
from __future__ import annotations

import torch

from portbench import bench, generate, weights, work
from portbench.reference import vqt

LIMITS = {"loss_gap": 6e-4, "grad_gap": 1e-2, "change_gap": 1e-2}
# steps whose loss is compared: the third step's gap is the first two's
# amplified about tenfold, by the program and by the control alike
# (PERF.md)
LOSS_STEPS = 2


def batch(ctx, index: int):
    """Step ``index``'s feed: tokens and sampled positions [b, n] and each
    layer's Gumbel noise [b, n, hq, Q], drawn on the device."""
    tr, cfg = ctx.traffic, ctx.cfg
    b, n = tr["batch"], tr["seq"]
    g = torch.Generator(device=ctx.device).manual_seed(
        int(generate.rng(ctx.seed, 10, index).integers(0, 1 << 62)))
    toks = torch.randint(0, cfg["vocab"], (b, n), generator=g, device=ctx.device)
    keys = torch.rand((b, cfg["pos_pool"]), generator=g, device=ctx.device)
    pos = keys.topk(n, dim=1).indices.sort(dim=1).values
    vq = cfg["vqt"]
    u = torch.rand((cfg["n_layers"], b, n, vq["n_heads"], vq["codebook_size"]), generator=g,
                   device=ctx.device)
    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return toks.to(torch.int32), pos.to(torch.int32), list(noise)


def leaf_norms(tree) -> list:
    return [float(t.double().norm()) for t in vqt.leaves(tree)]


def gaps(got: list, want: list, skip=()) -> float:
    """The worst leaf's |got − want| over the larger of want and the median
    of want, leaving out the indices ``skip``."""
    med = sorted(want)[len(want) // 2]
    return max(abs(g - w) / max(w, med) for i, (g, w) in enumerate(zip(got, want))
               if i not in skip)


def judge(prog: dict, ref: dict) -> dict:
    """The numbers compared (``loss_gap``: the worst of the first
    ``LOSS_STEPS`` steps' losses, relative; ``grad_gap``, ``change_gap``: the
    worst leaf) and, not compared, every step's loss gap and the count of
    leaves left out of the change."""
    med = sorted(ref["grad_norms"])[len(ref["grad_norms"]) // 2]
    still = {i for i, g in enumerate(ref["grad_norms"]) if g < 1e-3 * med}
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    return dict(loss_gap=max(steps[:LOSS_STEPS]),
                grad_gap=gaps(prog["grad_norms"], ref["grad_norms"]),
                change_gap=gaps(prog["change_norms"], ref["change_norms"], still),
                step_loss_gaps=steps, still_leaves=len(still))


def clipped(ref: dict, opt: dict) -> list:
    """The reference's first gradient after clipping, by leaf."""
    total = sum(g * g for g in ref["grad_norms"]) ** 0.5
    scale = min(1.0, opt["grad_clip"] / (total + 1e-9))
    return [g * scale for g in ref["grad_norms"]]


def run(ctx, *, fault=None) -> bench.Outcome:
    """``fault(step) -> step`` wraps the program's step (tests)."""
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.step import TrainState, make_train_step

    tr, cfg, out = ctx.traffic, ctx.cfg, bench.Outcome()
    W = weights.draw(cfg, ctx.seed, ctx.device)
    opt = tr["adamw"]
    step = make_train_step(bench.arch(cfg), lambda _: tr["lr"], AdamWConfig(**opt))
    if fault is not None:
        step = fault(step)
    state = TrainState(params=W, opt=adamw_init(W),
                       rng=torch.tensor([ctx.seed % (1 << 31), 0], dtype=torch.int64))
    feeds = [batch(ctx, i) for i in range(tr["checked_steps"])]
    prog = dict(losses=[])
    for i, (toks, pos, noise) in enumerate(feeds):
        state, m = step(state, {"tokens": toks, "positions": pos}, vq_noise=noise)
        prog["losses"].append(float(m["lm_loss"] + m["aux_loss"]))
        if i == 0:
            prog["grad_norms"] = [x / (1 - opt["b1"]) for x in leaf_norms(state.opt.mu)]
    prog["change_norms"] = [float((a - b).double().norm()) for a, b in
                            zip(vqt.leaves(state.params), vqt.leaves(W))]
    tokens_step = tr["batch"] * tr["seq"]
    bwd = BwdLaunches() if ctx.trace else None
    trace = bench.DeviceTrace(ctx).__enter__() if ctx.trace else None
    if bwd is not None:
        bwd.on = True
    steps, index = 0, tr["checked_steps"]
    nxt = batch(ctx, index)
    ctx.sync()
    t0 = ctx.now()
    out.e2e["setup_s"] = t0 - ctx.t_start
    while True:
        t_s = ctx.now()
        toks, pos, noise = nxt
        state, m = step(state, {"tokens": toks, "positions": pos}, vq_noise=noise)
        index += 1
        nxt = batch(ctx, index)
        ctx.sync()
        steps += 1
        now = ctx.now()
        if ctx.trace:
            ctx.spans.append(("train_step", t_s, now))
        if trace is not None and now - t0 >= min(tr["trace_seconds"], ctx.seconds):
            bwd.on = False
            trace.__exit__(None, None, None)
            out.obs.update(trace=trace.result, paused_s=trace.cost)
            trace = None
        if now - t0 >= ctx.seconds:
            break
    window = ctx.now() - t0
    out.memory_peak_bytes = ctx.peak_bytes()
    out.attempted = steps
    out.e2e["train_tokens_per_s"] = steps * tokens_step / window
    per_step = 3 * work.forward_flops(cfg, tokens_step, tr["batch"] *
                                      work.causal_pairs(tr["seq"], tr["seq"]), tokens_step)
    out.obs.update(window_s=window, steps=steps, train_flops=steps * per_step)
    if "trace" in out.obs:
        t = out.obs["trace"]
        bwd.close()
        out.obs["attn_bwd"] = dict(bound_s=bwd.bound_s(), calls=len(bwd.calls),
                                   kernel=bench.kernel_time(t, "gated_attention_bwd"))
        out.trace = dict(busy_s=t["busy_s"], window_s=t["window_s"],
                         breakdown=bench.breakdown(t, ctx.spans))
    elif bwd is not None:
        bwd.close()
    del state, m, nxt
    ctx.release()
    ref = reference(W, cfg, feeds, tr, "float32")
    res = judge(prog, ref)
    with vqt.precision("float32"):
        res["gumbel_ties"], res["gumbel_lead"] = vqt.gumbel_ties(W, cfg, *feeds[0], 1e-5)
    for name, lim in LIMITS.items():
        out.check(name, res[name], lim)
    out.obs["judged"] = res
    if ctx.control:
        out.obs["control"] = judge(reference(W, cfg, feeds, tr, ctx.control), ref)
        half = [(t[: len(t) // 2], p[: len(p) // 2], [x[: len(x) // 2] for x in n])
                for t, p, n in feeds]
        out.obs["fault_half_batch"] = judge(reference(W, cfg, half, tr, "float32"), ref)
    return out


def reference(W: dict, cfg: dict, feeds: list, tr: dict, kind: str) -> dict:
    with vqt.precision(kind):
        ref = vqt.train_steps(W, cfg, feeds, tr["adamw"], tr["lr"], len(feeds))
    ref["grad_norms"] = clipped(ref, tr["adamw"])
    return ref


class BwdLaunches:
    """Records each σ attention backward call's (BH, n, dh) while ``on``,
    by wrapping the entry the autograd function calls."""

    def __init__(self):
        from repro_torch.kernels.gated_attention import ops

        self.mod, self.orig = ops, ops.gated_attention_bwd_bh
        self.calls: list = []
        self.on = False

        def wrapped(q, k, v, do):
            if self.on:
                self.calls.append(tuple(q.shape))
            return self.orig(q, k, v, do)
        ops.gated_attention_bwd_bh = wrapped

    def close(self) -> None:
        self.mod.gated_attention_bwd_bh = self.orig

    def bound_s(self) -> float:
        return sum(work.bound_s(*work.attention_bwd_work(BH, n, dh)) for BH, n, dh in self.calls)
