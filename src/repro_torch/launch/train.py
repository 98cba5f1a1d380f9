"""Training launcher — the port of ``repro/launch/train.py``.

CPU smoke run:
  PYTHONPATH=src python -m repro_torch.launch.train --arch vq-opt-125m --smoke \\
      --device cpu --steps 50 --batch 8 --seq 128

``--arch`` takes any registry arch whose input is plain tokens, as the
reference's launcher: the GQA stacks (VQ-OPT, phi4-mini, stablelm,
h2o-danube, gemma3), hymba, rwkv6 and the MLA / MoE stacks (deepseek-v2,
-v3 with its MTP loss), each with ``--vqt`` where VQT applies. The VLM and
audio archs (internvl2, musicgen) train through ``make_train_step`` with
their patch embeddings or codebook tokens, which the synthetic corpus does
not make. Without ``--device cpu`` it trains on the card. ``--mesh host``
(one device) is the only mesh: the reference's production meshes
(``single``, ``pod``) come with ROADMAP Queue A item 11.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_train_state
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, lm_batches
from repro_torch.training import make_schedule, make_train_step, train_state_init


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--vqt", action="store_true", help="enable the paper's VQT feature")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", choices=["host", "single", "pod"], default="host")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} needs the production meshes of ROADMAP Queue A item 11")
    device = resolve_device(args.device)
    kwargs = {"vqt": True} if args.vqt else {}
    cfg = get_config(args.arch, smoke=args.smoke, **kwargs)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab}")

    sched = make_schedule(peak_lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps, final_lr=args.lr / 10)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    step_fn = make_train_step(cfg, sched, accum_steps=args.accum)
    t0 = time.time()
    for i, batch in enumerate(
        lm_batches(corpus, batch=args.batch, seq_len=args.seq, steps=args.steps,
                   pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None)
    ):
        state, m = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(
                f"step {i:5d} loss={float(m['lm_loss']):.4f} "
                f"aux={float(m['aux_loss']):.4f} gnorm={float(m['grad_norm']):.3f} "
                f"lr={float(m['lr']):.2e} ({time.time()-t0:.1f}s)",
                flush=True,
            )
    if args.ckpt:
        save_train_state(args.ckpt, state, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
