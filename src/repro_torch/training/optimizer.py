"""AdamW and learning-rate schedules — the port of
``repro/training/optimizer.py``, with the reference's arithmetic: the
global gradient norm in f32, clipping by ``min(1, clip / (norm + 1e-9))``,
bias correction with ``b ** step``, ``eps`` outside the square root, and
weight decay on every leaf (the sampled-position pool included).
``torch.optim.AdamW`` orders these operations differently, so it is not
used; the updates run as ``torch._foreach_*`` calls over the flattened
tree, in passes of bounded size, each pass on one device. Trees are
nested dicts / lists / tuples of f32 tensors, or of leaves laid out on a
grid (``distributed.context.Blocks``): then every block tensor is updated,
the norm counts each distinct slice once, and the copies of a replicated
leaf, given equal gradients, stay bitwise equal. The update returns new
tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.common.pytree import tensor_leaves, tree_leaves, with_tensor_leaves


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> AdamWState:
    zeros = lambda t: with_tensor_leaves(  # noqa: E731
        t, [torch.zeros_like(a, dtype=torch.float32) for a in tensor_leaves(t)])
    dev = tensor_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(params), nu=zeros(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32, added leaf
    by leaf in tree order as the reference's Python ``sum``; a placed leaf
    adds one holder of each distinct slice, on the first leaf's device."""
    total = None
    for leaf in tree_leaves(tree):
        parts = ([held[0][1] for held in leaf.replicas()] if hasattr(leaf, "replicas")
                 else [leaf])
        for a in parts:
            sq = torch.sum(torch.square(a.to(torch.float32)))
            total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


# Elements of the flattened tree an update pass takes (256 MB of f32): the
# update's temporaries (about ten a pass) stay this small, so a step holds
# the old and new parameters and moments and the gradients (28 B a
# parameter) and little more.
PASS_ELEMENTS = 1 << 26


def _passes(numels: list, cap: int):
    """The flattened leaves of sizes ``numels`` as passes of at most ``cap``
    elements: lists of (leaf, start, stop), a leaf larger than ``cap``
    split across passes."""
    group, size = [], 0
    for i, n in enumerate(numels):
        for start in range(0, n, cap):
            stop = min(start + cap, n)
            if group and size + stop - start > cap:
                yield group
                group, size = [], 0
            group.append((i, start, stop))
            size += stop - start
    if group:
        yield group


def adamw_update(params, grads, state: AdamWState, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, new_state, {"grad_norm"}). The element-wise
    update runs in passes of ``PASS_ELEMENTS`` (the same operations on
    each element as one pass over the whole tree)."""
    p = tensor_leaves(params)
    g = tensor_leaves(grads)
    m, v = tensor_leaves(state.mu), tensor_leaves(state.nu)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    new_p = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in p]
    mu = [torch.empty(x.shape, dtype=torch.float32, device=x.device) for x in m]
    nu = [torch.empty(x.shape, dtype=torch.float32, device=x.device) for x in v]
    flat = [[t.reshape(-1) for t in ts] for ts in (p, g, m, v, new_p, mu, nu)]
    by_device: dict = {}
    for i, x in enumerate(p):
        by_device.setdefault(x.device, []).append(i)
    for dev, members in by_device.items():
        # the scalars copied to each device: exact, so every device's
        # elements take the same operations on the same values
        sc, b1, b2, lr_d = (t.to(dev) for t in (scale, b1c, b2c, lr))
        for group in _passes([p[i].numel() for i in members], PASS_ELEMENTS):
            fp, fg, fm, fv, out_p, out_m, out_v = (
                [ts[members[i]][a:b] for i, a, b in group] for ts in flat)
            gs = torch._foreach_mul([x.to(torch.float32) for x in fg], sc)
            mi = torch._foreach_add(torch._foreach_mul(fm, cfg.b1),
                                    torch._foreach_mul(gs, 1 - cfg.b1))
            ni = torch._foreach_add(torch._foreach_mul(fv, cfg.b2),
                                    torch._foreach_mul(torch._foreach_mul(gs, 1 - cfg.b2), gs))
            mhat = torch._foreach_div(mi, b1)
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(ni, b2)), cfg.eps)
            pf = [x.to(torch.float32) for x in fp]
            delta = torch._foreach_add(torch._foreach_div(mhat, denom),
                                       torch._foreach_mul(pf, cfg.weight_decay))
            pi = torch._foreach_sub(pf, torch._foreach_mul(delta, lr_d))
            for outs, vals in ((out_m, mi), (out_v, ni), (out_p, pi)):
                for o, val in zip(outs, vals):
                    o.copy_(val)
    return (with_tensor_leaves(params, new_p),
            AdamWState(step=step, mu=with_tensor_leaves(state.mu, mu),
                       nu=with_tensor_leaves(state.nu, nu)),
            {"grad_norm": gnorm})


def make_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_lr: float = 0.0, kind: str = "cosine") -> Callable:
    """Linear warmup then cosine (or linear) decay — paper §4 uses 5K
    warmup to 5e-4 then cosine to 5e-5. ``schedule(step)`` takes an int or
    an integer tensor and returns an f32 scalar tensor."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        if kind == "cosine":
            decay = final_lr + 0.5 * (peak_lr - final_lr) * (1 + torch.cos(math.pi * prog))
        else:
            decay = peak_lr + (final_lr - peak_lr) * prog
        return torch.where(step < warmup_steps, warm, decay)

    return schedule
