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
not make. Without ``--device cpu`` it trains on the card.

As in the reference, every step runs under a grid (``use_mesh``):
``--mesh host`` (the default) is a 1x1 ("data", "model") grid of the one
device, so a MoE layer goes through the expert-parallel
``moe_apply_ep`` at one model slice, with the reference's fixed capacity.
``--mesh single`` / ``pod`` build the reference's (16, 16) and
(2, 16, 16) grids of CUDA devices (``make_mesh`` raises a ``ValueError``
on a machine with fewer cards), place the train state there by its plan
(``launch.sharding.place_state``) and run each step across the grid
(``models.sharded``), every family alike. A checkpoint is saved from the
assembled leaves.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_train_state
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, lm_batches
from repro_torch.distributed.context import use_mesh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.sharding import place_state, unplace
from repro_torch.training import make_schedule, make_train_step, train_state_init


def make_grid(mesh: str, device):
    """The grid ``--mesh`` names: the host grid of ``device``, or a
    production grid of CUDA devices (raises with fewer visible)."""
    if mesh == "host":
        return make_host_mesh(device)
    return make_production_mesh(multi_pod=mesh == "pod")


def place_for(state, cfg, grid):
    """``state`` placed on ``grid`` by its plan when the grid has more than
    one entry; else as it is."""
    return state if grid.devices.size == 1 else place_state(state, grid)


def grid_step(step_fn, grid):
    """``step_fn`` run under ``use_mesh(grid)``, as the reference's
    launcher runs its jitted step inside the mesh context."""

    def run(state, batch, **kw):
        with use_mesh(grid):
            return step_fn(state, batch, **kw)

    return run


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

    device = resolve_device(args.device)
    kwargs = {"vqt": True} if args.vqt else {}
    cfg = get_config(args.arch, smoke=args.smoke, **kwargs)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab}")
    grid = make_grid(args.mesh, device)

    sched = make_schedule(peak_lr=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps, final_lr=args.lr / 10)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=0)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    state = place_for(state, cfg, grid)
    step_fn = grid_step(make_train_step(cfg, sched, accum_steps=args.accum), grid)
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
        save_train_state(args.ckpt, unplace(state), step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
