"""End-to-end driver of the paper's §4 pipeline at the reduced config:

  1. train a plain-OPT teacher on the synthetic corpus;
  2. distil it into a VQ-OPT student (Gumbel-ST VQ, σ-attention, sampled
     positional embeddings);
  3. fine-tune both on the planted-topic classification task and evaluate
     with hard VQ;
  4. measure the distilled student's edit-processing op speedup.

    PYTHONPATH=src python -m repro_torch.examples.distill_vqt [--steps 300] [--device cpu]

The port's counterpart of ``examples/distill_vqt.py``, on ``--device``
(default ``cuda``). It keeps its own copies of the reference benchmark's
``_train_lm``, ``_distill`` and ``_finetune_classify``
(``benchmarks/table1_accuracy.py``), and step 4 counts ops with the port's
``IncrementalServer`` on a seeded stream of 24 atomic edits to a 384-token
document, where the reference calls its Table 2 benchmark.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs.vq_opt_125m import smoke_config
from repro_torch.core.edits import apply_edit, random_atomic_edit
from repro_torch.data import SyntheticCorpus, lm_batches
from repro_torch.models import transformer as T
from repro_torch.serving.engine import IncrementalServer
from repro_torch.training import (
    adamw_init, adamw_update, make_distill_step, make_schedule, make_train_step,
    train_state_init,
)
from repro_torch.training.losses import classification_loss
from repro_torch.training.step import value_and_grad


def _train_lm(cfg, corpus, steps, device, seed=0, batch=8, seq=96):
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    step = make_train_step(
        cfg, make_schedule(peak_lr=6e-4, warmup_steps=steps // 10, total_steps=steps))
    for b in lm_batches(corpus, batch=batch, seq_len=seq, steps=steps, seed=seed,
                        pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None):
        state, m = step(state, b)
    return state.params, float(m["lm_loss"])


def _distill(student_cfg, teacher_cfg, teacher_params, corpus, steps, device, seed=1,
             batch=8, seq=96):
    state = train_state_init(student_cfg, generator=torch.Generator().manual_seed(seed),
                             device=device)
    step = make_distill_step(
        student_cfg, teacher_cfg,
        make_schedule(peak_lr=6e-4, warmup_steps=steps // 10, total_steps=steps))
    for b in lm_batches(corpus, batch=batch, seq_len=seq, steps=steps, seed=seed,
                        pos_pool=student_cfg.pos_pool if student_cfg.pos == "sampled" else None):
        state, m = step(state, teacher_params, b)
    return state.params, {k: float(v) for k, v in m.items()}


def _finetune_classify(cfg, params, corpus, steps, device, seed=2, batch=8, seq=96,
                       eval_docs=64):
    """Mean-pooled hidden states and a linear head fine-tuned with the
    model (Gumbel VQ), then a held-out evaluation in eval mode (hard VQ).
    Returns (accuracy, F1)."""
    head = {"w": torch.zeros((cfg.d_model, 2), device=device),
            "b": torch.zeros((2,), device=device)}
    full = {"model": params, "head": head}
    opt = adamw_init(full)
    sched = make_schedule(peak_lr=7e-4, warmup_steps=max(steps // 10, 1), total_steps=steps)
    rng_pos = np.random.default_rng(seed)

    def batch_of(i, n_docs, base):
        toks, labels = [], []
        for j in range(n_docs):
            d, lab = corpus.classification_doc(seq, base + i * n_docs + j)
            toks.append(d)
            labels.append(lab)
        out = {"tokens": torch.as_tensor(np.stack(toks), device=device),
               "labels": torch.as_tensor(np.asarray(labels), device=device)}
        if cfg.pos == "sampled":
            pos = np.sort(np.stack([rng_pos.choice(cfg.pos_pool, seq, replace=False)
                                    for _ in range(n_docs)]), axis=-1)
            out["positions"] = torch.as_tensor(pos.astype(np.int32), device=device)
        return out

    def classify(full, b, **kw):
        logits, aux = T.forward(full["model"], cfg, b["tokens"], b.get("positions"), **kw)
        return aux["hidden"].mean(dim=1) @ full["head"]["w"] + full["head"]["b"], aux

    def loss_fn(full, b, gen):
        cls, aux = classify(full, b, train=True, rng=gen)
        loss, acc = classification_loss(cls, b["labels"])
        return loss + 0.1 * aux["aux_loss"], {"acc": acc}

    for i in range(steps):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        _, _, grads = value_and_grad(loss_fn, full, batch_of(i, batch, base=0), gen)
        full, opt, _ = adamw_update(full, grads, opt, sched(i))

    correct = total = tp = fp = fn = 0
    with torch.no_grad():
        for i in range(eval_docs // batch):
            b = batch_of(i, batch, base=500_000)
            pred = torch.argmax(classify(full, b)[0], -1).cpu().numpy()
            lab = b["labels"].cpu().numpy()
            correct += int((pred == lab).sum())
            total += len(lab)
            tp += int(((pred == 1) & (lab == 1)).sum())
            fp += int(((pred == 1) & (lab == 0)).sum())
            fn += int(((pred == 0) & (lab == 1)).sum())
    return correct / total, 2 * tp / max(2 * tp + fp + fn, 1)


def _edit_speedups(cfg, params, corpus, device, doc_len=384, n_edits=24, seed=0):
    """A seeded stream of atomic edits through the op-counting server:
    (cumulative speedup, median per-edit ratio of dense to counted ops)."""
    server = IncrementalServer(params, cfg, device=device)
    tokens = [int(t) for t in corpus.document(doc_len, seed)]
    server.open_document("doc", tokens)
    rng = np.random.default_rng(seed)
    ratios = []
    for _ in range(n_edits):
        e = random_atomic_edit(rng, tokens, cfg.vocab)
        ops = server.apply_edit("doc", e)
        tokens = apply_edit(tokens, e)
        ratios.append(server._dense_ops(len(tokens)) / max(ops, 1))
    return server.stats.speedup, float(np.median(ratios))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="build/vq_opt_distilled.npz",
                    help="where the distilled weights go (default under the ignored build/)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()

    teacher_cfg = smoke_config(vqt=False)
    student_cfg = smoke_config(vqt=True)
    corpus = SyntheticCorpus(vocab=teacher_cfg.vocab, seed=0)

    print(f"[1/4] training teacher ({args.steps} steps)...")
    teacher_params, lm_loss = _train_lm(teacher_cfg, corpus, args.steps, device)
    print(f"      teacher LM loss {lm_loss:.3f}  ({time.time()-t0:.0f}s)")

    print(f"[2/4] distilling VQ-OPT (h=2) ({args.steps} steps)...")
    student_params, m = _distill(student_cfg, teacher_cfg, teacher_params, corpus,
                                 args.steps, device)
    print(f"      kl={m['kl']:.3f} lm={m['lm']:.3f}  ({time.time()-t0:.0f}s)")
    save_pytree(args.ckpt, student_params)
    print(f"      saved distilled weights -> {args.ckpt}")

    print("[3/4] classification fine-tune (teacher vs student)...")
    ft_steps = max(args.steps // 2, 50)
    acc_t, _ = _finetune_classify(teacher_cfg, teacher_params, corpus, ft_steps, device)
    acc_s, _ = _finetune_classify(student_cfg, student_params, corpus, ft_steps, device)
    print(f"      teacher acc={acc_t:.3f}  VQ-OPT acc={acc_s:.3f} "
          f"(paper: 94.4 vs 90.3 at full scale)  ({time.time()-t0:.0f}s)")

    print("[4/4] edit-processing speedups with the *distilled* student...")
    speedup, median = _edit_speedups(student_cfg, student_params, corpus, device)
    print(f"      VQ-OPT distilled: cumulative {speedup:.1f}X over 24 atomic edits, "
          f"per-edit median {median:.1f}X  ({time.time()-t0:.0f}s)")


if __name__ == "__main__":
    main()
