"""Parameter initialisation for the VQ-Transformer, in the JAX package's
parameter layout (``repro/models/transformer.py:init_params``).

Only ``init_params`` is ported so far: it lets the port build weights at
any width without JAX. Shapes and scale rules follow the reference
(``embedding.py:12-21``, ``attention.py:45-56``, ``ffn.py:8-27``,
``norms.py:21``); the draws come from a ``torch.Generator`` and therefore
differ from ``jax.random``'s. Parity tests hand the reference's own weights
to both packages instead (``serving.jit_engine.weights_from_params``).

Layout::

    embed.tok [vocab, d], embed.pos [pool, d]
    final_norm.{scale, bias} [d]
    stages[i]: tuple over the stage pattern of per-layer dicts, every leaf
        stacked over the stage's repeat axis:
        norm1/norm2.{scale, bias}, ffn.{w_up, b_up, w_down, b_down},
        mixer.{wq, bq, wk, bk, wv, bv, wo, bo}, mixer.vq.codebook [hq, Q, d_vq]
    lm_head [d, vocab] (untied configurations only)
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def _layer_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg,
                repeat: int) -> dict:
    if layer.mixer != "gqa" or layer.ffn not in ("gelu", "relu", "relu2"):
        raise ValueError(
            f"init_params supports OPT-style blocks; got mixer={layer.mixer} "
            f"ffn={layer.ffn}")
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    r = (repeat,)
    zeros = lambda *s: torch.zeros(r + s, dtype=torch.float32)
    ones = lambda *s: torch.ones(r + s, dtype=torch.float32)
    mixer = {
        "wq": _normal(gen, r + (d, H * dh), d ** -0.5),
        "wk": _normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wv": _normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wo": _normal(gen, r + (H * dh, d), (H * dh) ** -0.5),
    }
    if cfg.attn_bias:
        mixer.update(bq=zeros(H * dh), bk=zeros(Hkv * dh), bv=zeros(Hkv * dh),
                     bo=zeros(d))
    if cfg.vqt is not None:
        hq = cfg.vqt.n_heads
        if (H * dh) % hq:
            raise ValueError(f"d_model={H * dh} not divisible by vq heads={hq}")
        mixer["vq"] = {"codebook": _normal(
            gen, r + (hq, cfg.vqt.codebook_size, H * dh // hq), 0.5)}
    if cfg.norm != "layernorm":
        raise ValueError(f"init_params supports layernorm; got {cfg.norm}")
    return {
        "norm1": {"scale": ones(d), "bias": zeros(d)},
        "norm2": {"scale": ones(d), "bias": zeros(d)},
        "mixer": mixer,
        "ffn": {
            "w_up": _normal(gen, r + (d, cfg.d_ff), d ** -0.5),
            "b_up": zeros(cfg.d_ff),
            "w_down": _normal(gen, r + (cfg.d_ff, d), cfg.d_ff ** -0.5),
            "b_down": zeros(d),
        },
    }


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device="cuda") -> dict:
    """Random float32 parameters for ``cfg`` in the reference layout (see the
    module docstring), drawn on the CPU from ``generator`` and moved to
    ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model
    if cfg.pos == "sampled":
        n_pos = cfg.pos_pool if cfg.pos_pool else cfg.max_seq * 100
    elif cfg.pos == "learned":
        n_pos = cfg.max_seq
    else:
        raise ValueError(f"init_params supports absolute positions; got {cfg.pos}")
    params: dict = {"embed": {
        "tok": _normal(generator, (cfg.vocab, d), 0.02),
        "pos": _normal(generator, (n_pos, d), 0.02),
    }}
    params["stages"] = [
        tuple(_layer_init(generator, cfg, layer, repeat) for layer in pattern)
        for pattern, repeat in cfg.stages
    ]
    params["final_norm"] = {"scale": torch.ones(d), "bias": torch.zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (d, cfg.vocab), d ** -0.5)
    return _to(params, dev)
