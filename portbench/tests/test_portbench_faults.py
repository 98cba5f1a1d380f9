"""Each cell's comparison catches a broken timed path: the rest of a run
(set-up, window, judging) is driven on the CPU at the smoke sizes with a
fault planted underneath the program's entry, and ``correct`` has to come
out false. The faults a cell can have: a step that returns its state
unchanged, half of the batch left out, and a token altered where it is
produced (the cells run on one card: no exchange between cards to leave
out). The unbroken run is correct."""
from __future__ import annotations

import pytest
import torch

import _smoke
from portbench import bench

torch.set_num_threads(4)


def run(cfg, mix, kw, **extra):
    ctx = _smoke.context(cfg, mix, **kw)
    return bench.driver(ctx.traffic).run(ctx, **extra)


# ---------------------------------------------------------------- edits


def edit_fault(kind):
    from repro_torch.serving.batch_engine import BatchedJitEngine

    orig = BatchedJitEngine.batch_apply_edits

    def broken(self, state, slot, tok, pos_id, op):
        if kind == "token":
            tok = torch.as_tensor(tok) + 1
        new, over = orig(self, state, slot, tok, pos_id, op)
        if kind == "unchanged":
            return state, torch.zeros_like(over)
        if kind == "half" and state.x.shape[0] > 1:
            keep = state.x.shape[0] // 2
            new = type(new)(*(torch.cat([a[:keep], b[keep:]]) for a, b in zip(new, state)))
        return new, over
    return broken


@pytest.mark.parametrize("kind", ["none", "unchanged", "half", "token"])
def test_edits(monkeypatch, kind):
    from repro_torch.serving.batch_engine import BatchedJitEngine

    if kind != "none":
        monkeypatch.setattr(BatchedJitEngine, "batch_apply_edits", edit_fault(kind))
    out = run("vq-opt-125m", "edits", dict(_smoke.EDITS, max_batch=4, docs=8))
    assert out.correct == (kind == "none"), out.checks


# ---------------------------------------------------------------- prefill


@pytest.mark.parametrize("kind", ["none", "unchanged", "half", "token"])
def test_prefill(monkeypatch, kind):
    from repro_torch.models import transformer as T

    orig = T.prefill_step

    def broken(params, cfg, tokens, caches, positions):
        if kind == "token":
            tokens = tokens.clone()
            tokens[:, 0] = (tokens[:, 0] + 1) % cfg.vocab
        logits, new = orig(params, cfg, tokens, caches, positions)
        if kind == "unchanged":
            return logits, caches
        if kind == "half":
            half = tokens.shape[0] // 2

            def mix(a, b):
                return torch.cat([a[:, :half], b[:, half:]], dim=1) if a.dim() > 1 else a
            new = [tuple({"mix": {k: mix(n["mix"][k], c["mix"][k]) for k in n["mix"]}}
                         for n, c in zip(ns, cs)) for ns, cs in zip(new, caches)]
            logits = torch.cat([logits[:half], torch.zeros_like(logits[half:])])
        return logits, new
    if kind != "none":
        monkeypatch.setattr(T, "prefill_step", broken)
    out = run("phi4-mini-3.8b", "prefill", _smoke.PREFILL)
    assert out.correct == (kind == "none"), out.checks


# ---------------------------------------------------------------- assist


@pytest.mark.parametrize("kind", ["none", "unchanged", "token"])
def test_assist(monkeypatch, kind):
    """A suggestion is one document's answer: no batch to halve."""
    from repro_torch.serving.suggest import SuggestionEngine

    orig = SuggestionEngine.refresh
    first: dict = {}

    def broken(self, engine, state, **kw):
        toks = orig(self, engine, state, **kw)
        if kind == "unchanged":
            return first.setdefault(kw.get("key"), toks)
        toks = toks.copy()
        toks[-1] = (toks[-1] + 1) % self.cfg.vocab
        return toks
    if kind != "none":
        monkeypatch.setattr(SuggestionEngine, "refresh", broken)
    out = run("vq-opt-125m", "assist", _smoke.ASSIST)
    assert out.correct == (kind == "none"), out.checks


# ---------------------------------------------------------------- train


def train_fault(kind):
    def wrap(step):
        def broken(state, batch, *, vq_noise=None):
            if kind == "unchanged":
                _, m = step(state, batch, vq_noise=vq_noise)
                return state, m
            if kind == "half":
                half = batch["tokens"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()},
                            vq_noise=[n[:half] for n in vq_noise])
            toks = batch["tokens"].clone()
            toks[:, 1] = (toks[:, 1] + 1) % 512
            return step(state, dict(batch, tokens=toks), vq_noise=vq_noise)
        return broken
    return wrap


@pytest.mark.parametrize("kind", ["none", "unchanged", "half", "token"])
def test_train(kind):
    out = run("vq-opt-125m", "train", _smoke.TRAIN,
              fault=None if kind == "none" else train_fault(kind))
    assert out.correct == (kind == "none"), out.checks
