"""The plain reference against the program on the CPU at the smoke sizes,
on the benchmark's own weights: the forward with the reference's own codes
and with the program's, and one run of each cell's driver judged correct
with numbers at float32 rounding. (The reference imports nothing of the
program; this test may.)"""
from __future__ import annotations

import pytest
import torch

import _smoke
from portbench import bench, weights
from portbench.reference import vqt

torch.set_num_threads(4)


def program_forward(cfg: dict, W: dict, toks, pos):
    """The program's forward logits, and the codes its VQ chose, by layer."""
    from repro_torch.core import vq
    from repro_torch.models import transformer as T

    codes, orig = [], vq.vq_assign

    def tap(x, cb):
        idx, xq = orig(x, cb)
        codes.append(idx[0])
        return idx, xq
    vq.vq_assign = tap
    try:
        logits, _ = T.forward(W, bench.arch(cfg), toks[None], pos[None])
    finally:
        vq.vq_assign = orig
    return logits[0], codes


@pytest.mark.parametrize("name", ["vq-opt-125m", "phi4-mini-3.8b"])
@pytest.mark.parametrize("seed", [0, 3_000_000_007])
def test_forward_matches_the_program(name, seed):
    cfg = _smoke.config(name)
    W = weights.draw(cfg, seed, "cpu")
    n = 96
    toks = torch.randint(0, cfg["vocab"], (n,), generator=torch.Generator().manual_seed(seed))
    pos = (torch.arange(n) * 7 + 3) if cfg["pos"] == "sampled" else torch.arange(n)
    got, codes = program_forward(cfg, W, toks, pos)
    rec = vqt.forward(W, cfg, toks, pos, lambda l: codes[l])
    last = vqt.logits(W, cfg, rec.xs[-1][-1:])[0]
    assert rec.gap < 1e-5
    assert float((got[-1] - last).abs().max()) <= 1e-5 * float(last.abs().max())
    if rec.flips == 0:
        own = vqt.logits(W, cfg, vqt.forward(W, cfg, toks, pos).xs[-1])
        assert float((got - own).abs().max()) <= 1e-5 * float(own.abs().max())


@pytest.mark.parametrize("cell", [("vq-opt-125m", "edits", _smoke.EDITS),
                                  ("phi4-mini-3.8b", "prefill", _smoke.PREFILL),
                                  ("vq-opt-125m", "assist", _smoke.ASSIST),
                                  ("vq-opt-125m", "train", _smoke.TRAIN)],
                         ids=lambda c: f"{c[0]}.{c[1]}")
def test_each_cell_is_judged_correct(cell):
    name, mix, kw = cell
    ctx = _smoke.context(name, mix, seed=11, **kw)
    out = bench.driver(ctx.traffic).run(ctx)
    assert out.correct, out.checks
    assert out.attempted > 0
    for key, value in out.obs["judged"].items():
        if key.endswith(("err", "gap")):
            assert value < 1e-5, (key, value)


def test_the_reference_step_follows_the_optimizer_rule():
    """One AdamW step of the reference against the rule worked by hand."""
    p, g = [torch.tensor([1.0, -2.0])], [torch.tensor([0.5, 0.25])]
    opt = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    p1, m1, v1, n1 = vqt.adamw(p, g, [torch.zeros(2)], [torch.zeros(2)], 1, 0.1, opt)
    assert n1 == pytest.approx(float(g[0].norm()))
    gs = g[0] * min(1.0, 1.0 / (n1 + 1e-9))
    want = p[0] - 0.1 * (gs / (gs.abs() + 1e-8) + 0.1 * p[0])
    assert torch.allclose(p1[0], want, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 3_000_000_011])
def test_an_off_suggestion_is_explained_only_by_a_near_tie(monkeypatch, seed):
    """The assist judge's explanation: served tokens that the reference
    gives once one of its VQ choices is taken the other way are explained
    by that choice; a token altered besides is not. Every choice counts as
    a near tie here, so the smoke model has one that moves a token."""
    from portbench.drivers import assist

    cfg = _smoke.config("vq-opt-125m")
    W = weights.draw(cfg, seed, "cpu")
    n, m = 40, 8
    t = torch.randint(0, cfg["vocab"], (n + m,), generator=torch.Generator().manual_seed(seed))
    p = torch.arange(n + m) * 7 + 3
    rec = vqt.forward(W, cfg, t, p, near=float("inf"))
    lg = vqt.logits(W, cfg, rec.xs[-1][n - 1:n - 1 + m])
    monkeypatch.setattr(assist, "TRIES", len(rec.ties))
    for lead, l, r, h, alt in sorted(x for x in rec.ties if x[2] < n - 1 + m):
        flipped = rec.codes[l].clone()
        flipped[r, h] = alt
        x = vqt.forward(W, cfg, t, p, lambda j: flipped if j == l else None).xs[-1]
        picked = vqt.logits(W, cfg, x[n - 1:n - 1 + m]).argmax(-1)
        if assist.gaps_of(lg, picked).max() > assist.TIE:
            break
    else:
        pytest.fail("no choice taken the other way moves a token")
    assert assist.explained(W, cfg, t, p, n, m, picked, rec) is not None
    worst = picked.clone()
    worst[-1] = lg[-1].argmin()
    assert assist.explained(W, cfg, t, p, n, m, worst, rec) is None
