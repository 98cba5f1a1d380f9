"""Batched decode serving step — the port of ``repro/serving/decode.py``.

``serve_step`` consumes ONE new token per sequence against per-layer KV
caches and returns next-token logits (or sampled tokens) plus the updated
caches — the continuous-batching inner loop. Sampling draws from an
explicit ``torch.Generator`` where the reference takes a ``jax.random``
key; the two give different draws, so only greedy decoding is held against
the reference. Under a grid (``use_mesh`` of more than one entry) every
step runs the caches' plan (``models.sharded_decode``): the loops take and
return caches laid out on the grid (``launch.sharding.place_caches``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.context import active_grid
from repro_torch.models import transformer as T


def make_serve_step(cfg: ArchConfig, *, sample: bool = False, temperature: float = 1.0):
    """Returns ``serve_step(params, caches, tokens, positions, generator?) ->
    (next_tokens_or_logits, caches)``. Under a grid, place the parameters
    once (``launch.sharding.place(params, grid, copy=False)``): whole
    parameters are laid out again on every call, which on a grid of
    distinct cards copies them each step."""

    def serve_step(params, caches, tokens, positions,
                   generator: Optional[torch.Generator] = None):
        logits, caches = T.decode_step(params, cfg, tokens, caches, positions)
        if not sample:
            return logits, caches
        if temperature == 0.0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            if generator is None:
                raise ValueError("sampling at temperature > 0 needs a generator")
            probs = torch.softmax(logits / temperature, dim=-1)
            flat = probs.reshape(-1, probs.shape[-1])
            nxt = torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])
        return nxt.to(torch.int32), caches

    return serve_step


def greedy_continue(step, params, caches, logits_last: torch.Tensor,
                    gen_positions: torch.Tensor,
                    on_token=None) -> tuple[torch.Tensor, list]:
    """The greedy continuation loop shared by ``greedy_decode`` and the
    suggestion engine: ``logits_last`` [b, vocab] are the logits of the last
    consumed token; ``gen_positions`` [b, n_new] the continuation position
    ids. Runs ``n_new - 1`` decode steps (the first token needs none).
    ``on_token``, when given, is called with each [b, 1] token array (numpy)
    as the loop produces it — a streaming tap that forces a device sync per
    token. Returns (tokens [b, n_new] int32, caches)."""
    n_new = gen_positions.shape[1]
    cur = torch.argmax(logits_last, dim=-1).to(torch.int32)[:, None]
    if on_token is not None:
        on_token(cur.cpu().numpy())
    out = [cur]
    for i in range(1, n_new):
        logits, caches = step(params, caches, cur, gen_positions[:, i - 1:i])
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        if on_token is not None:
            on_token(cur.cpu().numpy())
        out.append(cur)
    return torch.cat(out, dim=1), caches


def greedy_decode(params, cfg: ArchConfig, prompt: torch.Tensor, n_new: int,
                  cache_len: int = 0, positions: Optional[torch.Tensor] = None,
                  gen_positions: Optional[torch.Tensor] = None):
    """Greedy decoding for tests and examples: prefill the prompt [b, n] in
    ONE ``prefill_step`` (``chunkable`` configs; else token by token), then
    generate ``n_new`` tokens. ``positions`` [b, n] / ``gen_positions``
    [b, n_new] override the dense 0..n+n_new-1 ids (gapped-id documents pass
    their own). Under a grid the parameters are placed once, and the prompt
    goes token by token (the first step places the caches by their plan).
    Returns (generated [b, n_new], caches)."""
    b, n = prompt.shape[:2]
    if cache_len and cache_len < n + n_new:
        # full caches clamp out-of-range writes: generating past the end
        # would silently stomp the last KV row
        raise ValueError(f"cache_len {cache_len} < prompt + n_new = {n + n_new}")
    dev = prompt.device
    caches = T.init_caches(cfg, b, cache_len or (n + n_new), dtype=torch.float32,
                           device=dev)
    step = make_serve_step(cfg, sample=False)
    grid = active_grid()
    if grid is not None:
        from repro_torch.launch.sharding import place

        params = place(params, grid, copy=False)
    if positions is None:
        positions = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    if gen_positions is None:
        gen_positions = (positions[:, -1:] + 1
                         + torch.arange(n_new, dtype=torch.int32, device=dev))
    if T.chunkable(cfg) and grid is None:
        logits, caches = T.prefill_step(params, cfg, prompt, caches, positions)
        logits = logits[:, -1:]
    else:
        for i in range(n):
            logits, caches = step(params, caches, prompt[:, i:i + 1],
                                  positions[:, i:i + 1])
    return greedy_continue(step, params, caches, logits[:, -1], gen_positions)
