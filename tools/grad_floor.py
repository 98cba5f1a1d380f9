"""How far a grid's train-step gradients lie from the 1x1 grid's, beside
how far one-ulp moves of the weights move each of them, leaf by leaf.

    python3 tools/grad_floor.py [--draws 5] [--tokens 2048]

For rwkv6-7b (full width, 4 layers) and hymba-1.5b (full width, 2 global
and 2 windowed layers, VQT), with ``chip_smoke.py``'s phase 23 (c) inputs
(seed-0 weights on the card's generator, the seed-1 Gumbel noise, one
sequence of ``--tokens``): ``lm_loss``'s gradients on the 1x1 grid and on
a (1, 2) grid of the card (laid out in the forward), then the same on the
weights each moved by one part in 2^24 with a random sign (seeds 1 to
``--draws``; the grid on the first two moves only). Prints one JSON line a
model: ``grid_err`` {leaf: the grid's max difference relative to the
leaf's max}, ``floor_1x1`` and ``floor_grid`` {leaf: [each move's
difference from its own unmoved run]}, ``codes_equal`` (the VQ codes a
move left alone); then the card's ``nvidia-smi`` name and power limit.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.common.pytree import (  # noqa: E402
    path_names, tree_flatten_with_path, tree_map_with_path,
)
from repro_torch.core import vq as vq_mod  # noqa: E402
from repro_torch.data import SyntheticCorpus, lm_batches  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402


def rel(got, want) -> dict:
    """{leaf: max |got - want| over the leaf's max |want|}."""
    w = dict(tree_flatten_with_path(want))
    return {"/".join(path_names(p)): float((g - w[p]).abs().max())
            / max(float(w[p].abs().max()), 1e-30) for p, g in tree_flatten_with_path(got)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=5)
    ap.add_argument("--tokens", type=int, default=2048)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, n = torch.device("cuda"), args.tokens
    for cfg in (cs.family_train_cfg("rwkv6-7b", 4), cs.hymba_cut(2, 2)):
        t0 = time.perf_counter()
        p = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=1, seq_len=n,
                                steps=1))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        one, two = cs.grid_of((1, 1), [dev]), cs.grid_of((1, 2), [dev])
        gen = torch.Generator(device=dev).manual_seed(1)
        noise = None if cfg.vqt is None else [
            vq_mod.gumbel(gen, (1, n, cfg.vqt.n_heads, cfg.vqt.codebook_size))
            for _ in range(cs.n_layers(cfg))]
        cs.grid_grads(p, cfg, batch, None, one, placed=False)  # warm
        base = cs.grid_grads(p, cfg, batch, noise, one, placed=False)
        grid = cs.grid_grads(p, cfg, batch, noise, two, placed=False)
        out = {"arch": cfg.name, "layers": cs.n_layers(cfg), "tokens": n,
               "grid_err": rel(grid["grads"], base["grads"]),
               "floor_1x1": {}, "floor_grid": {}, "codes_equal": []}
        for draw in range(args.draws):
            g = torch.Generator(device=dev).manual_seed(1 + draw)

            def moved(_path, x, g=g):
                sign = torch.randint(0, 2, x.shape, generator=g, device=x.device) * 2 - 1
                return x * (1 + sign * 2.0 ** -24)

            pm = tree_map_with_path(moved, p)
            m1 = cs.grid_grads(pm, cfg, batch, noise, one, placed=False)
            out["codes_equal"].append(all(torch.equal(a[0], c[0])
                                          for a, c in zip(base["codes"], m1["codes"])))
            for k, v in rel(m1["grads"], base["grads"]).items():
                out["floor_1x1"].setdefault(k, []).append(v)
            if draw < 2:
                m2 = cs.grid_grads(pm, cfg, batch, noise, two, placed=False)
                for k, v in rel(m2["grads"], grid["grads"]).items():
                    out["floor_grid"].setdefault(k, []).append(v)
            del pm
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del p, base, grid
        torch.cuda.empty_cache()
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
