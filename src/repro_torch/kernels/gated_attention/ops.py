"""Wrappers of the gated σ-attention kernels, the port of
``repro/kernels/gated_attention/ops.py``: the forward
(``csrc/gated_attention.cu``) and, for training, its gradient
(``csrc/gated_attention_bwd.cu``).

``gated_attention`` takes the model layout ([b, n, H, dh], GQA repeat
applied here, differentiably: the gradient of a repeated k or v head sums
over its repeats) and returns [b, n, H·dh], matching
``models.attention.full_attention`` with ``softmax=False``;
``gated_attention_bh`` is the kernels' own layout ([BH, n, dh]). Both are
differentiable through a ``torch.autograd.Function`` that saves q, k and v
(not the scores: the backward recomputes S). CPU tensors run the plain
versions (``ref.py``: the forward and the written-out backward); CUDA
tensors launch the kernels or raise. The backward kernels take dh = dv in
``BWD_HEAD_DIMS`` and nq = nk. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._launch import (
    FLOAT, INT, PTR, bind, check, check_aligned, raise_on_error, require_cuda,
    stream_of,
)
from repro_torch.kernels.gated_attention.ref import gated_attention_bwd_ref, gated_attention_ref

LAUNCHES = {"gated_attention": 0, "gated_attention_bwd_dkv": 0, "gated_attention_bwd_dq": 0}

HEAD_DIMS = (64, 128, 256)  # the head dims (of q, k and v) the kernel is instantiated for
BWD_HEAD_DIMS = (64, 128, 256)  # the head dims the backward kernels take
_MAX_BH = 65535  # batch-heads a launch takes
# gated_attention_launch(q, k, v, o, BH, nq, nk, dh, scale, stream)
ARGTYPES = [PTR] * 4 + [INT] * 4 + [FLOAT, PTR]
# gated_attention_bwd_dkv_launch(q, k, v, do, dk, dv, BH, n, scale, stream)
BWD_DKV_ARGTYPES = [PTR] * 6 + [INT] * 2 + [FLOAT, PTR]
# gated_attention_bwd_dq_launch(q, k, v, do, dq, BH, n, scale, stream)
BWD_DQ_ARGTYPES = [PTR] * 5 + [INT] * 2 + [FLOAT, PTR]
# the dh = 128 and 256 launchers take dh after n:
# gated_attention_bwd_wide_dkv_launch(q, k, v, do, dk, dv, BH, n, dh, scale, stream)
BWD_WIDE_DKV_ARGTYPES = [PTR] * 6 + [INT] * 3 + [FLOAT, PTR]
# gated_attention_bwd_wide_dq_launch(q, k, v, do, dq, BH, n, dh, scale, stream)
BWD_WIDE_DQ_ARGTYPES = [PTR] * 5 + [INT] * 3 + [FLOAT, PTR]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _forward_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version on CPU tensors, one launch on CUDA
    tensors."""
    if q.device.type == "cpu":
        return gated_attention_ref(q, k, v)
    require_cuda("gated_attention", q)
    BH, nq, dh = q.shape
    nk, dv = k.shape[1], v.shape[-1]
    if dh not in HEAD_DIMS or dv != dh:
        raise ValueError(f"the gated_attention kernel takes dh=dv in {HEAD_DIMS}, "
                         f"got dh={dh} dv={dv}")
    if nk < 1:
        raise ValueError("gated_attention needs nk >= 1")
    if BH > _MAX_BH:
        raise ValueError(f"gated_attention takes at most {_MAX_BH} batch-heads, got {BH}")
    dev = q.device
    check("q", q, (BH, nq, dh), dev)
    check("k", k, (BH, nk, dh), dev)
    check("v", v, (BH, nk, dv), dev)
    check_aligned(q=q, k=k, v=v)  # q as float2, k and v as 16-byte copies
    out = torch.empty((BH, nq, dv), dtype=torch.float32, device=dev)
    if BH == 0 or nq == 0:
        return out
    fn = bind("gated_attention", "gated_attention_launch", ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, nq,
                 nk, dh, float(dh ** -0.5), stream_of(dev))
    raise_on_error("gated_attention", err)
    LAUNCHES["gated_attention"] += 1
    return out


def gated_attention_bwd_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``gated_attention_bh`` at (q, k, v) for the output's
    gradient ``do``: (dq, dk, dv), each the shape of its input. q, k, v, do:
    [BH, n, dh], dh in ``BWD_HEAD_DIMS`` (training's nq = nk). CPU tensors
    run ``gated_attention_bwd_ref``; CUDA tensors launch the dK/dV kernel,
    then the dQ kernel (no atomics: two calls give the same bits); dh = 128
    and 256 have kernels of their own."""
    if q.device.type == "cpu":
        return gated_attention_bwd_ref(q, k, v, do)
    require_cuda("gated_attention_bwd", q)
    BH, n, dh = q.shape
    if k.shape[1] != n:
        raise ValueError(f"the gated_attention backward takes nq = nk, got nq={n} "
                         f"nk={k.shape[1]}")
    if dh not in BWD_HEAD_DIMS or v.shape[-1] != dh:
        raise ValueError(f"the gated_attention backward kernel takes dh = dv in "
                         f"{BWD_HEAD_DIMS}, got dh={dh} dv={v.shape[-1]}")
    if BH > _MAX_BH:
        raise ValueError(f"gated_attention takes at most {_MAX_BH} batch-heads, got {BH}")
    dev = q.device
    do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        check(name, t, (BH, n, dh), dev)
    check_aligned(q=q, k=k, v=v, do=do)
    dq, dk, dv = (torch.empty((BH, n, dh), dtype=torch.float32, device=dev) for _ in range(3))
    if BH == 0 or n == 0:
        return dq, dk, dv
    scale = float(dh ** -0.5)
    if dh == 64:
        dkv = bind("gated_attention_bwd", "gated_attention_bwd_dkv_launch", BWD_DKV_ARGTYPES)
        dqf = bind("gated_attention_bwd", "gated_attention_bwd_dq_launch", BWD_DQ_ARGTYPES)
        shape = (BH, n)
    else:
        dkv = bind("gated_attention_bwd", "gated_attention_bwd_wide_dkv_launch",
                   BWD_WIDE_DKV_ARGTYPES)
        dqf = bind("gated_attention_bwd", "gated_attention_bwd_wide_dq_launch",
                   BWD_WIDE_DQ_ARGTYPES)
        shape = (BH, n, dh)
    with torch.cuda.device(dev):
        stream = stream_of(dev)
        err = dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *shape, scale, stream)
        raise_on_error("gated_attention_bwd_dkv", err)
        LAUNCHES["gated_attention_bwd_dkv"] += 1
        err = dqf(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  *shape, scale, stream)
        raise_on_error("gated_attention_bwd_dq", err)
        LAUNCHES["gated_attention_bwd_dq"] += 1
    return dq, dk, dv


class _GatedAttention(torch.autograd.Function):
    """The forward launch, differentiated by the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward_bh(q, k, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        return gated_attention_bwd_bh(*ctx.saved_tensors, do)


def gated_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [BH, nq, dh]; k: [BH, nk, dh]; v: [BH, nk, dv] -> [BH, nq, dv] f32
    (causal, count-normalized; one launch on the card), differentiable."""
    return _GatedAttention.apply(q, k, v)


def gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [b, nq, H, dh]; k, v: [b, nk, Hkv, dh] -> [b, nq, H·dh]."""
    b, nq, H, dh = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    fold = lambda a: a.transpose(1, 2).reshape(b * H, a.shape[1], a.shape[-1]).contiguous()
    out = gated_attention_bh(fold(q), fold(k), fold(v))  # [b*H, nq, dh]
    return out.reshape(b, H, nq, dh).transpose(1, 2).reshape(b, nq, H * dh)
