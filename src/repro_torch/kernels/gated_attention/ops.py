"""Wrappers of the gated σ-attention kernel (``csrc/gated_attention.cu``),
the port of ``repro/kernels/gated_attention/ops.py``.

``gated_attention`` takes the model layout ([b, n, H, dh], GQA repeat
applied here) and returns [b, n, H·dh], matching
``models.attention.full_attention`` with ``softmax=False``;
``gated_attention_bh`` is the kernel's own layout ([BH, n, dh]). CPU tensors
run the plain version (``ref.py``); CUDA tensors launch the kernel or
raise. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    FLOAT, INT, PTR, bind, check, check_aligned, raise_on_error, require_cuda,
    stream_of,
)
from repro_torch.kernels.gated_attention.ref import gated_attention_ref

LAUNCHES = {"gated_attention": 0}

HEAD_DIMS = (64, 128, 256)  # the head dims (of q, k and v) the kernel is instantiated for
_MAX_BH = 65535  # batch-heads a launch takes
# gated_attention_launch(q, k, v, o, BH, nq, nk, dh, scale, stream)
ARGTYPES = [PTR] * 4 + [INT] * 4 + [FLOAT, PTR]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gated_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [BH, nq, dh]; k: [BH, nk, dh]; v: [BH, nk, dv] -> [BH, nq, dv] f32
    (causal, count-normalized; one launch on the card)."""
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
