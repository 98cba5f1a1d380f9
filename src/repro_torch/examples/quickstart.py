"""Quickstart: build a VQ-Transformer, run it, edit a document incrementally.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``, on ``--device``
(default ``cuda``) at the reduced config, with the port's seeded weights.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.edits import Edit, apply_edits
from repro_torch.models.transformer import forward, init_params
from repro_torch.serving.engine import IncrementalServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    # 1. A VQT model (the paper's vq-opt family, reduced).
    cfg = get_config("vq-opt-125m", smoke=True)  # vqt=True by default for this arch
    print(f"model: {cfg.name} — {cfg.n_layers} layers, d={cfg.d_model}, "
          f"σ-attention + VQ(h={cfg.vqt.n_heads}, q={cfg.vqt.codebook_size})")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device=args.device)

    # 2. Ordinary batched forward.
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    positions = torch.arange(64)[None].repeat(2, 1) * 3  # gapped absolute ids
    logits, aux = forward(params, cfg, tokens.to(args.device), positions.to(args.device))
    print(f"forward: logits {tuple(logits.shape)}, vq aux loss {float(aux['aux_loss']):.4f}")

    # 3. Incremental inference: open a document once, then pay only for edits.
    server = IncrementalServer(params, cfg, device=args.device)
    doc = [int(t) for t in np.random.default_rng(0).integers(0, cfg.vocab, 96)]
    server.open_document("draft", doc)

    edits = [Edit("replace", 10, 7), Edit("insert", 40, 123), Edit("delete", 80)]
    for e in edits:
        ops = server.apply_edit("draft", e)
        dense = server._dense_ops(len(server.tokens("draft")))
        print(f"{e.op:8s}@{e.pos:3d}: {ops:>12,} ops "
              f"({dense / max(ops, 1):5.1f}X cheaper than re-running)")
    assert list(server.tokens("draft")) == apply_edits(doc, edits)

    print(f"cumulative speedup so far: {server.stats.speedup:.1f}X")
    print(f"next-token logits after edits: {server.logits('draft')[:5]}")


if __name__ == "__main__":
    main()
