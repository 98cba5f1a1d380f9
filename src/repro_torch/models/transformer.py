"""The decoder stack — the port of ``repro/models/transformer.py`` for
OPT-style (GQA attention + dense FFN) stacks over plain tokens.

A model is a sequence of *stages* ``(pattern, repeat)`` (see
``configs.base``). Parameters of a stage are stacked along a leading
``repeat`` axis, as in the reference; where the reference runs a stage
under ``jax.lax.scan``, the port runs a Python loop over the repeat index.

Entry points:
  * ``init_params``  — random parameters in the reference layout (drawn
    from a ``torch.Generator``, so they differ from ``jax.random``'s);
    ``params_from_numpy`` carries the reference's own weights across;
  * ``forward``      — inference over [b, n] tokens (σ attention through the
    ``gated_attention`` kernel, VQ through ``vq_assign``);
  * ``prefill_step`` / ``decode_step`` — m tokens / one token per sequence
    against per-layer KV caches (``init_caches``, ``caches_from_kv``,
    ``set_cache_length``), the suggestion path.

Training, multi-token prediction and vision inputs come with later slices.

Parameter layout::

    embed.tok [vocab, d], embed.pos [pool, d]
    final_norm.{scale, bias} [d]
    stages[i]: tuple over the stage pattern of per-layer dicts, every leaf
        stacked over the stage's repeat axis:
        norm1/norm2.{scale, bias}, ffn.{w_up, b_up, w_down, b_down},
        mixer.{wq, bq, wk, bk, wv, bv, wo, bo}, mixer.vq.codebook [hq, Q, d_vq]
    lm_head [d, vocab] (untied configurations only)

Caches mirror the stages: a list over stages of tuples over the pattern of
``{"mix": {"k", "v": [repeat, b, S, Hkv, dh], "len": [repeat, b] int32}}``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.models.attention import (
    attn_apply, attn_cache_init, attn_decode, attn_prefill,
)
from repro_torch.models.embedding import embed_tokens
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.norms import apply_norm


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def _layer_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg,
                repeat: int) -> dict:
    if layer.mixer != "gqa" or layer.ffn != "gelu":
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


def params_from_numpy(tree, *, device="cuda"):
    """The reference-layout parameter tree as tensors on ``device``: a nested
    dict of numpy arrays (``tests/_torch_parity.params_to_numpy`` of the JAX
    package's params, so both packages compute with the same weights) or of
    tensors. Lists and tuples keep their type; every leaf is copied."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device=dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(dev, copy=True)
    return torch.tensor(np.asarray(tree), device=dev)


# ---------------------------------------------------------------- trees


def _index(tree, r: int):
    """Slice ``r`` of every leaf (the repeat axis of a stage)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, r) for v in tree)
    return tree[r]


def _stack(trees: list):
    """Stack same-structure trees along a new leading (repeat) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def _check_mixer(layer: LayerCfg) -> None:
    if layer.mixer != "gqa":
        raise NotImplementedError(
            f"the port runs gqa layers only so far; got mixer={layer.mixer}")


# ---------------------------------------------------------------- forward


def _layer_fwd(lp: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block: x + mixer(n1(x)); then x + ffn(n2(x))."""
    _check_mixer(layer)
    h = apply_norm(cfg.norm, lp["norm1"], x)
    mix, aux = attn_apply(lp["mixer"], cfg, layer, h, positions)
    x = x + mix
    h2 = apply_norm(cfg.norm, lp["norm2"], x)
    return x + ffn_apply(layer.ffn, lp["ffn"], h2), aux


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].T
    return x @ params["lm_head"]


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *, patch_embeds=None,
            train: bool = False, rng=None) -> tuple[torch.Tensor, dict]:
    """tokens: [b, n]; positions: [b, n] absolute ids (default 0..n-1).
    Returns (logits [b, n, vocab], {"aux_loss", "hidden"})."""
    if train:
        raise NotImplementedError("training comes with the port's training slice")
    if patch_embeds is not None:
        raise NotImplementedError("vision inputs come with the model-family slice")
    b, n = tokens.shape
    if positions is None:
        positions = torch.arange(n, dtype=torch.int32, device=tokens.device).expand(b, n)
    x = embed_tokens(params["embed"], cfg, tokens, positions)
    aux = torch.zeros((), device=x.device)
    for (pattern, repeat), sp in zip(cfg.stages, params["stages"]):
        for r in range(repeat):
            spr = _index(sp, r)
            for pi, layer in enumerate(pattern):
                x, a = _layer_fwd(spr[pi], cfg, layer, x, positions)
                aux = aux + a
    return _head(params, cfg, x), {"aux_loss": aux, "hidden": x}


# ---------------------------------------------------------------- caches


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32,
                device="cuda") -> list:
    """Per-stage stacked zero caches mirroring the parameter structure (f32
    by default: the reference's bf16 default is not served by the port)."""
    dev = resolve_device(device)
    caches = []
    for pattern, repeat in cfg.stages:
        per_layer = []
        for layer in pattern:
            _check_mixer(layer)
            c = attn_cache_init(cfg, layer, batch, seq_len, dtype, dev)
            per_layer.append({"mix": {k: torch.stack([t] * repeat) for k, t in c.items()}})
        caches.append(tuple(per_layer))
    return caches


def chunkable(cfg: ArchConfig) -> bool:
    """Whether ``prefill_step`` supports this config: non-windowed GQA
    stacks (the port's configs are plain-token, single-codebook)."""
    return all(layer.mixer == "gqa" and layer.window is None
               for layer in cfg.layer_list())


def _run_cached(params: dict, cfg: ArchConfig, tokens, caches: list, positions,
                attn_step) -> tuple[torch.Tensor, list]:
    """The stage loop shared by ``prefill_step`` and ``decode_step``:
    ``attn_step`` is ``attn_prefill`` or ``attn_decode``."""
    x = embed_tokens(params["embed"], cfg, tokens, positions)
    new_caches = []
    for (pattern, repeat), sp, sc in zip(cfg.stages, params["stages"], caches):
        per_repeat = []
        for r in range(repeat):
            spr, scr = _index(sp, r), _index(sc, r)
            new_scr = []
            for pi, layer in enumerate(pattern):
                _check_mixer(layer)
                lp = spr[pi]
                h = apply_norm(cfg.norm, lp["norm1"], x)
                mix, mc = attn_step(lp["mixer"], cfg, layer, h, scr[pi]["mix"], positions)
                x = x + mix
                h2 = apply_norm(cfg.norm, lp["norm2"], x)
                x = x + ffn_apply(layer.ffn, lp["ffn"], h2)
                new_scr.append({"mix": mc})
            per_repeat.append(tuple(new_scr))
        new_caches.append(_stack(per_repeat))
    return _head(params, cfg, x), new_caches


def prefill_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 caches: list, positions: torch.Tensor) -> tuple[torch.Tensor, list]:
    """``m`` new tokens per sequence in ONE step (``decode_step`` is the
    m = 1 case). tokens / positions: [b, m]. Returns (logits [b, m, vocab],
    new caches). Only ``chunkable`` configs."""
    if not chunkable(cfg):
        raise ValueError(
            f"{cfg.name}: chunked prefill requires non-windowed gqa layers "
            "over plain tokens — use per-token decode_step instead")
    return _run_cached(params, cfg, tokens, caches, positions, attn_prefill)


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: list, positions: torch.Tensor) -> tuple[torch.Tensor, list]:
    """One new token per sequence. tokens: [b, 1]. Returns (logits
    [b, 1, vocab], new caches)."""
    return _run_cached(params, cfg, tokens, caches, positions, attn_decode)


def caches_from_kv(cfg: ArchConfig, k: torch.Tensor, v: torch.Tensor, length, *,
                   seq_len: Optional[int] = None, dtype=torch.float32) -> list:
    """Decode caches from per-layer stacked K/V — e.g. the jit engine's
    ``export_kv``. k, v: [L, b, S0, Hkv, dh] sequence-ordered (rows past a
    document's real length may hold garbage — the cache ``length`` masks
    them); length: [b] rows to trust; ``seq_len`` pads the cache past S0 to
    leave room for continuation tokens."""
    layers = cfg.layer_list()
    if k.shape[0] != len(layers):
        raise ValueError(f"k carries {k.shape[0]} layers, config has {len(layers)}")
    b, S0 = k.shape[1], k.shape[2]
    S = seq_len if seq_len is not None else S0
    if S < S0:
        raise ValueError(f"seq_len {S} smaller than exported rows {S0}")
    length = torch.as_tensor(length, dtype=torch.int32, device=k.device).reshape(b)
    Hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    caches = []
    li = 0
    for pattern, repeat in cfg.stages:
        per_repeat = []
        for _ in range(repeat):
            per_layer = []
            for layer in pattern:
                if layer.mixer != "gqa" or layer.window is not None:
                    raise ValueError("caches_from_kv supports non-windowed gqa layers only")
                kb = torch.zeros((b, S, Hkv, dh), dtype=dtype, device=k.device)
                vb = torch.zeros((b, S, Hkv, dh), dtype=dtype, device=k.device)
                kb[:, :S0] = k[li].to(dtype)
                vb[:, :S0] = v[li].to(dtype)
                per_layer.append({"mix": {"k": kb, "v": vb, "len": length}})
                li += 1
            per_repeat.append(tuple(per_layer))
        caches.append(_stack(per_repeat))
    return caches


def set_cache_length(caches: list, length) -> list:
    """Rewind (or advance) every layer's cache length counter — the
    suggestion engine's prefix-reuse primitive: rows at/after ``length``
    become invisible to attention and are overwritten by the next
    prefill/decode writes. Full (non-ring) caches only."""
    if isinstance(caches, dict):
        return {key: (torch.full_like(val, length) if key == "len"
                      else set_cache_length(val, length))
                for key, val in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(set_cache_length(x, length) for x in caches)
    return caches
