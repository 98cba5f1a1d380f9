"""Serve small models of several architectures with batched greedy decode:
a KV cache (stablelm), ring-buffer sliding-window caches (gemma3's local
layers), MLA latent caches and routed experts (deepseek-v2), Mamba SSM and
conv states beside a KV cache (hymba), RWKV states (rwkv6) and
multi-codebook audio tokens (musicgen).

    PYTHONPATH=src python -m repro_torch.examples.multiarch_decode [--device cpu] [--vqt]

The port's counterpart of ``examples/multiarch_decode.py``, at the reduced
configs with the port's seeded weights. Each decode is checked against a
forward over the same tokens (the last step's logits within 2e-3).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving.decode import make_serve_step

B, PROMPT, NEW = 2, 12, 8
ARCHS = ["stablelm-1.6b", "gemma3-12b", "deepseek-v2-236b", "hymba-1.5b",
         "rwkv6-7b", "musicgen-large"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--vqt", action="store_true",
                    help="the paper's variant: σ-attention and VQ on every layer")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    for arch in ARCHS:
        cfg = get_config(arch, smoke=True, vqt=args.vqt)
        params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        shape = (B, PROMPT, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, PROMPT)
        prompt = torch.randint(0, cfg.vocab, shape,
                               generator=torch.Generator().manual_seed(1)).to(dev)
        caches = T.init_caches(cfg, B, PROMPT + NEW, device=dev)
        step = make_serve_step(cfg)
        t0 = time.time()
        cur, seq, out = prompt[:, :1], [], []
        for i in range(PROMPT + NEW):
            pos = torch.full((B, 1), i, dtype=torch.int32, device=dev)
            cur_in = prompt[:, i:i + 1] if i < PROMPT else cur
            seq.append(cur_in)
            logits, caches = step(params, caches, cur_in, pos)
            cur = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            if i >= PROMPT:
                out.append(cur)
        gen = torch.cat(out, dim=1)
        full, _ = T.forward(params, cfg, torch.cat(seq, dim=1))
        err = float((full[:, -1] - logits[:, -1]).abs().max())
        if not torch.allclose(logits[:, -1], full[:, -1], atol=2e-3, rtol=2e-3):
            raise AssertionError(f"{arch}: decode differs from the forward by {err}")
        print(f"{arch:20s} [{cfg.family:6s}] generated {tuple(gen.shape)} "
              f"in {time.time() - t0:.1f}s: {gen[0].reshape(-1)[:8].tolist()} "
              f"(decode matches the forward: {err:.1e})")


if __name__ == "__main__":
    main()
