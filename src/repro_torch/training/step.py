"""Train and distill steps with gradient accumulation — the port of
``repro/training/step.py``.

A step is eager PyTorch: the loss through ``transformer.forward(train=True)``
(the Gumbel straight-through VQ, each layer recomputed in the backward),
the gradients by ``torch.autograd.grad`` (the σ attention's by the
``gated_attention`` backward kernel on the card), then ``adamw_update``.
It returns a new ``TrainState`` and leaves the one it was given as it was.

``TrainState.rng`` is an int64 pair (seed, counter), where the reference
keeps a jax PRNG key: each step seeds its explicit ``torch.Generator`` on
the parameters' device from the pair and advances the counter, so the
state holds plain integers and a train-state file of either package reads
in the other. The Gumbel noise streams of the two packages differ by
design; a step's ``vq_noise`` takes given noise instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.common.pytree import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.training.losses import distill_loss, next_token_loss
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: AdamWState
    rng: torch.Tensor  # int64 [2]: (seed, counter)


def train_state_init(cfg: ArchConfig, *, generator: torch.Generator,
                     device="cuda") -> TrainState:
    """``init_params`` from ``generator`` on ``device``, zero AdamW moments,
    and an rng pair whose seed is the generator's next draw."""
    params = T.init_params(cfg, generator=generator, device=device)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator, device=generator.device))
    return TrainState(params=params, opt=adamw_init(params),
                      rng=torch.tensor([seed, 0], dtype=torch.int64))


def step_generator(rng: torch.Tensor, device) -> torch.Generator:
    """The step's generator on ``device``, seeded from the (seed, counter)
    pair."""
    seed, counter = (int(x) & 0xFFFFFFFF for x in rng.tolist())
    return torch.Generator(device=device).manual_seed((seed << 32) | counter)


def _next_rng(rng: torch.Tensor) -> torch.Tensor:
    seed, counter = (int(x) for x in rng.tolist())
    return torch.tensor([seed, counter + 1], dtype=torch.int64)


def _device(params: dict) -> torch.device:
    return tree_leaves(params)[0].device


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params, *args, **kwargs):
    """``loss_fn(params, *args, **kwargs) -> (loss, metrics)`` and the
    gradient of the loss in every leaf of ``params`` (zeros where it does
    not reach). Returns (loss, metrics, grads), detached."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, live), *args, **kwargs)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def lm_loss(params, cfg: ArchConfig, batch: dict, rng: Optional[torch.Generator], *,
            aux_weight: float = 1.0, vq_noise=None):
    """The LM objective of a train step (the reference's ``_lm_loss_fn``):
    next-token loss on the text positions plus the auxiliary losses (VQ's
    and the MoE router's) and, with an MTP head, 0.3 × its next-token loss
    of token t + 2 from position t. Returns (loss, {"lm_loss",
    "aux_loss"})."""
    logits, aux = T.forward(params, cfg, batch["tokens"], batch.get("positions"),
                            patch_embeds=batch.get("patch_embeds"), train=True, rng=rng,
                            vq_noise=vq_noise)
    n_text = batch["tokens"].shape[1]
    lm = next_token_loss(logits[:, -n_text:], batch["tokens"], batch.get("mask"))
    loss = lm + aux_weight * aux["aux_loss"]
    if "mtp_logits" in aux:
        loss = loss + 0.3 * next_token_loss(aux["mtp_logits"][:, :-1], batch["tokens"][:, 1:])
    return loss, {"lm_loss": lm, "aux_loss": aux["aux_loss"]}


def make_train_step(cfg: ArchConfig, schedule: Callable, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, accum_steps: int = 1):
    """Returns ``step(state, batch, *, vq_noise=None) -> (state, metrics)``.

    With ``accum_steps > 1`` the batch's leading axis is split as
    ``reshape(accum_steps, b // accum_steps, ...)`` and the gradients are
    averaged (live activation memory of one microbatch). Every microbatch
    draws from the same seed, as the reference reuses one rng under
    ``lax.scan``; the metrics are the last microbatch's."""

    def step(state: TrainState, batch: dict, *, vq_noise=None):
        dev = _device(state.params)
        batch = _on(batch, dev)
        grads_of = lambda mb: value_and_grad(  # noqa: E731
            lm_loss, state.params, cfg, mb, step_generator(state.rng, dev), vq_noise=vq_noise)
        if accum_steps == 1:
            _, metrics, grads = grads_of(batch)
        else:
            b = batch["tokens"].shape[0]
            micro = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
                     for k, v in batch.items()}
            total = None
            for i in range(accum_steps):
                _, metrics, g = grads_of({k: v[i] for k, v in micro.items()})
                g = tree_leaves(g)
                total = g if total is None else torch._foreach_add(total, g)
            grads = tree_unflatten(state.params, torch._foreach_div(total, float(accum_steps)))
        lr = schedule(state.opt.step)
        params, opt, om = adamw_update(state.params, grads, state.opt, lr, opt_cfg)
        return (TrainState(params=params, opt=opt, rng=_next_rng(state.rng)),
                {**metrics, **om, "lr": lr})

    return step


def make_distill_step(student_cfg: ArchConfig, teacher_cfg: ArchConfig, schedule: Callable,
                      opt_cfg: AdamWConfig = AdamWConfig(), *, aux_weight: float = 1.0):
    """Distillation step (paper §4: adapt OPT to VQ-OPT via Sanh et al.).

    ``step(state, teacher_params, batch, *, vq_noise=None) -> (state,
    metrics)``. The teacher runs in eval mode under ``torch.no_grad()`` at
    ``batch["teacher_positions"]`` (default 0..n-1); the student trains on
    KL + LM + the VQ auxiliary loss."""

    def loss_fn(params, t_logits, batch, rng, vq_noise=None):
        s_logits, aux = T.forward(params, student_cfg, batch["tokens"], batch.get("positions"),
                                  train=True, rng=rng, vq_noise=vq_noise)
        loss, parts = distill_loss(s_logits, t_logits, batch["tokens"])
        return loss + aux_weight * aux["aux_loss"], {**parts, "aux_loss": aux["aux_loss"]}

    def step(state: TrainState, teacher_params: dict, batch: dict, *, vq_noise=None):
        dev = _device(state.params)
        batch = _on(batch, dev)
        with torch.no_grad():
            t_logits, _ = T.forward(teacher_params, teacher_cfg, batch["tokens"],
                                    batch.get("teacher_positions"))
        loss, parts, grads = value_and_grad(loss_fn, state.params, t_logits, batch,
                                            step_generator(state.rng, dev), vq_noise=vq_noise)
        lr = schedule(state.opt.step)
        params, opt, om = adamw_update(state.params, grads, state.opt, lr, opt_cfg)
        return (TrainState(params=params, opt=opt, rng=_next_rng(state.rng)),
                {"loss": loss, **parts, **om, "lr": lr})

    return step
