"""The decoder stack — the port of ``repro/models/transformer.py`` for GQA
attention stacks (the paper's VQ-OPT and the dense-attention families:
RMSNorm or LayerNorm, RoPE or absolute positions, sliding windows, gated
or biased FFNs, vision prefixes, multi-codebook audio tokens), the
recurrent families (Hymba's hybrid attention + SSM mixer, RWKV6's time-mix
and channel-mix) and the MLA / MoE families (DeepSeek's latent attention,
routed + shared experts, V3's multi-token prediction head).

A model is a sequence of *stages* ``(pattern, repeat)`` (see
``configs.base``). Parameters of a stage are stacked along a leading
``repeat`` axis, as in the reference; where the reference runs a stage
under ``jax.lax.scan``, the port runs a Python loop over the repeat index.

Entry points:
  * ``init_params``  — random parameters in the reference layout (drawn
    from a ``torch.Generator``, so they differ from ``jax.random``'s);
    ``params_from_numpy`` carries the reference's own weights across;
  * ``forward``      — inference over [b, n] tokens ([b, n, cb] audio
    codes; vision patch embeddings prefixed for VLMs): σ GQA attention
    through the ``gated_attention`` kernel, VQ through ``vq_assign``; with
    ``cfg.mtp`` also DeepSeek-V3's depth-1 ``mtp_logits``;
  * ``prefill_step`` / ``decode_step`` — m tokens / one token per sequence
    against per-layer caches (``init_caches``: full KV caches, ring buffers
    for windowed layers, MLA latents, SSM / conv / RWKV states;
    ``caches_from_kv``, ``set_cache_length``). ``prefill_step`` and
    ``caches_from_kv`` take non-windowed GQA stacks only, as in the
    reference.

Training: ``forward(train=True)`` for every mixer and FFN (the Gumbel
straight-through VQ of gqa, mla and hymba layers, σ attention
differentiated by the ``gated_attention`` backward kernel, everything else
by autograd of plain PyTorch: MLA, the scans, windowed and streamed
attention, the MoE router's load-balance loss and the MTP head), each
layer recomputed in the backward with ``remat``.

Parameter layout::

    embed.tok [vocab, d] ([cb, vocab, d] for audio), embed.pos [pool, d]
        (learned / sampled positions only), embed.vis_proj [d, d] (VLMs)
    final_norm.scale [d] (+ .bias for LayerNorm)
    stages[i]: tuple over the stage pattern of per-layer dicts, every leaf
        stacked over the stage's repeat axis:
        norm1/norm2.{scale[, bias]},
        ffn.{w_gate, w_up, w_down} (swiglu, geglu) or
            ffn.{w_up, b_up, w_down, b_down} (gelu, relu, relu2),
            ffn.{router, w_gate, w_up, w_down[, shared]} (moe, ``models.moe``),
            ffn.{mu, w_k, w_v, w_r} (rwkv_cm, ``models.rwkv6``),
        mixer.{wq, wk, wv, wo[, bq, bk, bv, bo]}, mixer.vq.codebook [hq, Q, d_vq]
            (gqa; mla, hymba and rwkv6: ``models.mla``, ``models.hymba``,
            ``models.rwkv6``)
    lm_head [d, vocab * cb] (untied configurations only)
    mtp.{norm_h, norm_e, norm_f}.scale [d], mtp.proj [2d, d],
        mtp.ffn.{w_gate, w_up, w_down} (d_ff wide; ``cfg.mtp`` only)

Caches mirror the stages: a list over stages of tuples over the pattern of
``{"mix": c}``, every leaf of c stacked over the stage's repeat axis: gqa
``{"k", "v": [b, S, Hkv, dh], "len": [b] int32}``; mla ``{"ckv": [b, S,
kv_lora], "krope": [b, S, rope], "len"}``; hymba ``{"attn": that,
"ssm_state": [b, H, d_state, dh], "conv_state": [b, d_conv - 1, H·dh]}``;
rwkv6 ``{"tm": {"S": [b, H, dh, dh], "x_last": [b, d]}, "cm_x_last": [b, d]}``.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, LayerCfg
from repro_torch.core import vq as vq_mod
from repro_torch.models import normal
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import (
    attn_apply, attn_cache_init, attn_decode, attn_prefill,
)
from repro_torch.models.embedding import embed_tokens, merge_vision
from repro_torch.models.ffn import ffn_apply
from repro_torch.models.hymba import hymba_apply, hymba_cache_init, hymba_decode, hymba_init
from repro_torch.models.mla import mla_apply, mla_cache_init, mla_decode, mla_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.norms import apply_norm, norm_init

_MIXERS = ("gqa", "mla", "hymba", "rwkv6")


def _check_mixer(layer: LayerCfg) -> None:
    if layer.mixer not in _MIXERS:
        raise ValueError(f"unknown mixer {layer.mixer!r}")


def _ffn_init(gen: torch.Generator, kind: str, d: int, d_ff: int, r: tuple) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"w_gate": normal(gen, r + (d, d_ff), d ** -0.5),
                "w_up": normal(gen, r + (d, d_ff), d ** -0.5),
                "w_down": normal(gen, r + (d_ff, d), d_ff ** -0.5)}
    if kind in ("gelu", "relu", "relu2"):
        return {"w_up": normal(gen, r + (d, d_ff), d ** -0.5),
                "b_up": torch.zeros(r + (d_ff,)),
                "w_down": normal(gen, r + (d_ff, d), d_ff ** -0.5),
                "b_down": torch.zeros(r + (d,))}
    raise ValueError(kind)


def _attn_init(gen: torch.Generator, cfg: ArchConfig, r: tuple) -> dict:
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    zeros = lambda *s: torch.zeros(r + s, dtype=torch.float32)
    mixer = {
        "wq": normal(gen, r + (d, H * dh), d ** -0.5),
        "wk": normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wv": normal(gen, r + (d, Hkv * dh), d ** -0.5),
        "wo": normal(gen, r + (H * dh, d), (H * dh) ** -0.5),
    }
    if cfg.attn_bias:
        mixer.update(bq=zeros(H * dh), bk=zeros(Hkv * dh), bv=zeros(Hkv * dh),
                     bo=zeros(d))
    if cfg.vqt is not None:
        mixer["vq"] = vq_mod.init(gen, H * dh, cfg.vqt, r)
    return mixer


def _layer_init(gen: torch.Generator, cfg: ArchConfig, layer: LayerCfg,
                repeat: int) -> dict:
    _check_mixer(layer)
    d, r = cfg.d_model, (repeat,)
    if layer.mixer == "mla":
        mixer = mla_init(gen, cfg, layer, r)
    elif layer.mixer == "hymba":
        mixer = hymba_init(gen, cfg, layer, r)
    elif layer.mixer == "rwkv6":
        mixer = rwkv_mod.rwkv_init(gen, cfg, layer, r)
    else:
        mixer = _attn_init(gen, cfg, r)
    if layer.ffn == "moe":
        ffn = moe_init(gen, cfg, r)
    elif layer.ffn == "rwkv_cm":
        ffn = rwkv_mod.cm_init(gen, cfg, r)
    else:
        ffn = _ffn_init(gen, layer.ffn, d, cfg.d_ff, r)
    return {"norm1": norm_init(cfg.norm, d, r), "norm2": norm_init(cfg.norm, d, r),
            "mixer": mixer, "ffn": ffn}


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device="cuda") -> dict:
    """Random float32 parameters for ``cfg`` in the reference layout (see the
    module docstring), drawn from ``generator`` on its own device (a CPU
    generator gives every process the same bits; a CUDA one draws a
    billions-of-parameters model in a fraction of the host's time) and
    moved to ``device``."""
    dev = resolve_device(device)
    d = cfg.d_model
    cb = cfg.n_codebooks
    tok_shape = (cb, cfg.vocab, d) if cb > 1 else (cfg.vocab, d)
    embed = {"tok": normal(generator, tok_shape, 0.02)}
    if cfg.pos == "sampled":
        embed["pos"] = normal(generator, (cfg.pos_pool or cfg.max_seq * 100, d), 0.02)
    elif cfg.pos == "learned":
        embed["pos"] = normal(generator, (cfg.max_seq, d), 0.02)
    elif cfg.pos not in ("rope", "none"):
        raise ValueError(f"unknown pos={cfg.pos!r}")
    if cfg.input_mode == "vlm":
        embed["vis_proj"] = normal(generator, (d, d), d ** -0.5)
    params: dict = {"embed": embed}
    params["stages"] = [
        tuple(_layer_init(generator, cfg, layer, repeat) for layer in pattern)
        for pattern, repeat in cfg.stages
    ]
    params["final_norm"] = norm_init(cfg.norm, d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (d, cfg.vocab * max(cb, 1)), d ** -0.5)
    if cfg.mtp:
        params["mtp"] = {"norm_h": norm_init(cfg.norm, d), "norm_e": norm_init(cfg.norm, d),
                         "proj": normal(generator, (2 * d, d), (2 * d) ** -0.5),
                         "ffn": _ffn_init(generator, "swiglu", d, cfg.d_ff, ()),
                         "norm_f": norm_init(cfg.norm, d)}
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


# ---------------------------------------------------------------- forward


def _ffn_fwd(lp: dict, cfg: ArchConfig, layer: LayerCfg,
             h2: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A stateless FFN (dense or MoE) on the normed h2. Returns (y, the MoE
    aux loss or None)."""
    if layer.ffn == "moe":
        return moe_apply(lp["ffn"], cfg, h2)
    return ffn_apply(layer.ffn, lp["ffn"], h2), None


def _layer_fwd(lp: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
               positions: torch.Tensor, vq_noise: Optional[torch.Tensor] = None, *,
               train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm block: x + mixer(n1(x)); then x + ffn(n2(x)). Returns (x,
    the layer's aux loss: VQ's, 0 at inference, plus the MoE router's).
    ``train`` runs the training-mode VQ of gqa, mla and hymba layers with
    ``vq_noise``."""
    _check_mixer(layer)
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if layer.mixer == "mla":
        mix, aux = mla_apply(lp["mixer"], cfg, layer, h, positions, train=train,
                             vq_noise=vq_noise)
    elif layer.mixer == "hymba":
        mix, aux = hymba_apply(lp["mixer"], cfg, layer, h, positions, train=train,
                               vq_noise=vq_noise)
    elif layer.mixer == "rwkv6":
        mix, _, _ = rwkv_mod.rwkv_time_mix(lp["mixer"], cfg, h)
        aux = torch.zeros((), device=x.device)
    else:
        mix, aux = attn_apply(lp["mixer"], cfg, layer, h, positions, train=train,
                              vq_noise=vq_noise)
    x = x + mix
    h2 = apply_norm(cfg.norm, lp["norm2"], x)
    if layer.ffn == "rwkv_cm":
        y, _ = rwkv_mod.rwkv_channel_mix(lp["ffn"], h2)
    else:
        y, moe_aux = _ffn_fwd(lp, cfg, layer, h2)
        if moe_aux is not None:
            aux = aux + moe_aux
    return x + y, aux


def _head(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits [b, n, vocab] ([b, n, cb, vocab] with codebooks)."""
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        emb = params["embed"]["tok"]
        if cfg.n_codebooks > 1:
            return torch.einsum("bnd,cvd->bncv", x, emb)
        return x @ emb.T
    logits = x @ params["lm_head"]
    if cfg.n_codebooks > 1:
        b, n, _ = logits.shape
        return logits.reshape(b, n, cfg.n_codebooks, cfg.vocab)
    return logits


def _layer_noise(cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor, li: int,
                 gen: torch.Generator, vq_noise) -> Optional[torch.Tensor]:
    """Layer ``li``'s Gumbel noise [b, n, hq, Q]: ``vq_noise[li]`` when
    given, else drawn from ``gen``; None for a layer without VQ (rwkv6)."""
    if cfg.vqt is None or layer.mixer == "rwkv6":
        return None
    if vq_noise is not None:
        return torch.as_tensor(vq_noise[li], dtype=torch.float32, device=x.device)
    shape = (*x.shape[:2], cfg.vqt.n_heads, cfg.vqt.codebook_size)
    return vq_mod.gumbel(gen, shape).to(x.device)


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *, patch_embeds=None,
            train: bool = False, rng: Optional[torch.Generator] = None,
            vq_noise=None, remat: bool = True) -> tuple[torch.Tensor, dict]:
    """tokens: [b, n] (audio: [b, n, n_codebooks]); positions: [b, n]
    absolute ids (default 0..n-1). For VLM inputs ``patch_embeds``
    [b, n_patches, d] are projected and prefixed, at positions
    0..n_patches-1 (the text's shifted after them); logits cover the whole
    sequence. Returns (logits [b, n, vocab] or [b, n, cb, vocab],
    {"aux_loss", "hidden"} and, with ``cfg.mtp``, "mtp_logits": the depth-1
    multi-token prediction from h_t and the embedding of token t + 1, the
    last row's next token wrapping to the first as ``jnp.roll`` does).

    ``train`` mirrors the reference's ``_run_stages`` (``transformer.py:
    146-186``): each VQ layer draws its own Gumbel noise from the generator
    ``rng`` (a seed-0 generator on the tokens' device when None), before the
    layer body — ``torch.utils.checkpoint`` (``remat``, the reference's
    ``jax.checkpoint``) recomputes the body in the backward and does not
    replay an explicit generator. ``vq_noise``, a list indexed by the
    layer's global index, overrides the draws."""
    b, n = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(n, dtype=torch.int32, device=tokens.device).expand(b, n)
    x = embed_tokens(params["embed"], cfg, tokens, positions)
    if cfg.input_mode == "vlm":
        if patch_embeds is None:
            raise ValueError("vlm input requires patch_embeds")
        x = merge_vision(params["embed"], patch_embeds, x)
        npat = patch_embeds.shape[1]
        positions = torch.cat(
            [torch.arange(npat, dtype=positions.dtype, device=x.device).expand(b, npat),
             positions + npat], dim=1)
    aux = torch.zeros((), device=x.device)
    if train and rng is None:
        rng = torch.Generator(device=x.device).manual_seed(0)
    li = 0
    for (pattern, repeat), sp in zip(cfg.stages, params["stages"]):
        for r in range(repeat):
            spr = _index(sp, r)
            for layer, lp in zip(pattern, spr):
                if train:
                    noise = _layer_noise(cfg, layer, x, li, rng, vq_noise)
                    body = partial(_layer_fwd, lp, cfg, layer, train=True)
                    x, a = (checkpoint(body, x, positions, noise, use_reentrant=False,
                                       preserve_rng_state=False)
                            if remat else body(x, positions, noise))
                else:
                    x, a = _layer_fwd(lp, cfg, layer, x, positions)
                aux = aux + a
                li += 1
    out_aux = {"aux_loss": aux, "hidden": x}
    if cfg.mtp and "mtp" in params:
        m = params["mtp"]
        emb_next = torch.roll(
            embed_tokens(params["embed"], cfg, tokens, positions[:, -n:]), -1, dims=1)
        hcat = torch.cat([apply_norm(cfg.norm, m["norm_h"], x[:, -n:]),
                          apply_norm(cfg.norm, m["norm_e"], emb_next.to(x.dtype))], dim=-1)
        h_mtp = hcat @ m["proj"]
        h_mtp = h_mtp + ffn_apply("swiglu", m["ffn"], apply_norm(cfg.norm, m["norm_f"], h_mtp))
        out_aux["mtp_logits"] = _head(params, cfg, h_mtp)
    return _head(params, cfg, x), out_aux


# ---------------------------------------------------------------- caches


def _layer_cache_init(cfg: ArchConfig, layer: LayerCfg, batch: int, seq_len: int,
                      dtype, device) -> dict:
    _check_mixer(layer)
    if layer.mixer == "mla":
        return mla_cache_init(cfg, layer, batch, seq_len, dtype, device)
    if layer.mixer == "hymba":
        return hymba_cache_init(cfg, layer, batch, seq_len, dtype, device)
    if layer.mixer == "rwkv6":
        return rwkv_mod.rwkv_state_init(cfg, batch, dtype, device)
    return attn_cache_init(cfg, layer, batch, seq_len, dtype, device)


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.float32,
                device="cuda") -> list:
    """Per-stage stacked zero caches mirroring the parameter structure: a
    ring of ``min(window, seq_len)`` slots for windowed layers (f32 by
    default: the reference's bf16 default is not served by the port)."""
    dev = resolve_device(device)
    return [tuple({"mix": _stack([_layer_cache_init(cfg, layer, batch, seq_len, dtype, dev)]
                                 * repeat)} for layer in pattern)
            for pattern, repeat in cfg.stages]


def chunkable(cfg: ArchConfig) -> bool:
    """Whether ``prefill_step`` supports this config: plain-token GQA stacks
    with no sliding windows (a ring cache takes one token a step). MLA,
    hymba and rwkv6 decode token by token, as in the reference."""
    return (cfg.input_mode == "tokens" and cfg.n_codebooks == 1
            and all(layer.mixer == "gqa" and layer.window is None
                    and layer.ffn != "rwkv_cm" for layer in cfg.layer_list()))


def _layer_prefill(lp: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                   cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """m tokens through one (non-windowed GQA) layer against its KV cache.
    Returns (x, the layer's new cache)."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    mix, mc = attn_prefill(lp["mixer"], cfg, layer, h, cache["mix"], positions)
    x = x + mix
    h2 = apply_norm(cfg.norm, lp["norm2"], x)
    return x + _ffn_fwd(lp, cfg, layer, h2)[0], mc


def _layer_decode(lp: dict, cfg: ArchConfig, layer: LayerCfg, x: torch.Tensor,
                  cache: dict, positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One token through one layer of any mixer against its cache. rwkv6
    carries its channel-mix token shift (``cm_x_last``) in the mixer's
    cache, as the reference. Returns (x, the layer's new cache)."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if layer.mixer == "mla":
        mix, mc = mla_decode(lp["mixer"], cfg, layer, h, cache["mix"], positions)
    elif layer.mixer == "hymba":
        mix, mc = hymba_decode(lp["mixer"], cfg, layer, h, cache["mix"], positions)
    elif layer.mixer == "rwkv6":
        mix, tm = rwkv_mod.rwkv_time_mix_step(lp["mixer"], cfg, h, cache["mix"]["tm"])
        mc = {"tm": tm, "cm_x_last": cache["mix"]["cm_x_last"]}
    else:
        mix, mc = attn_decode(lp["mixer"], cfg, layer, h, cache["mix"], positions)
    x = x + mix
    h2 = apply_norm(cfg.norm, lp["norm2"], x)
    if layer.ffn == "rwkv_cm":
        y, mc["cm_x_last"] = rwkv_mod.rwkv_channel_mix(lp["ffn"], h2, cache["mix"]["cm_x_last"])
    else:
        y = _ffn_fwd(lp, cfg, layer, h2)[0]
    return x + y, mc


def _run_cached(params: dict, cfg: ArchConfig, tokens, caches: list, positions,
                layer_step) -> tuple[torch.Tensor, list]:
    """The stage loop shared by ``prefill_step`` and ``decode_step``:
    ``layer_step`` is ``_layer_prefill`` or ``_layer_decode``."""
    x = embed_tokens(params["embed"], cfg, tokens, positions)
    new_caches = []
    for (pattern, repeat), sp, sc in zip(cfg.stages, params["stages"], caches):
        per_repeat = []
        for r in range(repeat):
            spr, scr = _index(sp, r), _index(sc, r)
            new_scr = []
            for pi, layer in enumerate(pattern):
                _check_mixer(layer)
                x, mc = layer_step(spr[pi], cfg, layer, x, scr[pi], positions)
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
    return _run_cached(params, cfg, tokens, caches, positions, _layer_prefill)


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: list, positions: torch.Tensor) -> tuple[torch.Tensor, list]:
    """One new token per sequence. tokens: [b, 1] (audio [b, 1, cb]).
    Returns (logits [b, 1, ...], new caches)."""
    return _run_cached(params, cfg, tokens, caches, positions, _layer_decode)


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
