"""Wrappers of the VQ assignment kernel (``csrc/vq_assign.cu``), the port
of ``repro/kernels/vq_assign/ops.py``.

CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise; meta tensors return meta outputs and count the kernel's
work (``_launch.meta_work``). ``vq_assign`` quantizes any leading shape in one launch
(B = 1); ``vq_assign_batched`` takes [B, N, d] documents in one launch over
their B·N tokens, the codebook shared. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    INT, PTR, bind, check, meta_work, raise_on_error, require_cuda, stream_of,
)
from repro_torch.kernels.vq_assign.ref import vq_assign_ref

LAUNCHES = {"vq_assign": 0}

_QMAX = 256  # the largest codebook the kernel takes
# The launcher's schedules, by the index it takes: a block per token and head,
# then the register-tiled product with 16- or 32-token tiles.
SCHEDULES = ("small", "large16", "large32")
# Token counts up to these run the first and the second schedule. On an H100
# at hq=2, Q=64, dv=384 the small and the 16-token schedule cross between 384
# and 512 tokens, the two tiles between 1,024 and 1,536 (``chip_smoke.py
# --sweep``; PERF.md section 6).
_SMALL_MAX_TOKENS = 384
_LARGE16_MAX_TOKENS = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def schedule(tokens: int) -> str:
    """The kernel's schedule for a call on ``tokens`` = B·N tokens, one of
    SCHEDULES: "small" (decode and short prefill chunks), "large16" (long
    prefill chunks) or "large32" (the forward). A fixed rule, not an
    option."""
    if tokens <= _SMALL_MAX_TOKENS:
        return "small"
    return "large16" if tokens <= _LARGE16_MAX_TOKENS else "large32"


def _meta(xh: torch.Tensor, codebook: torch.Tensor):
    """The kernel's outputs as meta tensors, and its work: 2·Q·dv
    operations a token and head; x and the codebook read, x_q and the
    indices written once."""
    B, N, hq, dv = xh.shape
    Q = codebook.shape[1]
    meta_work("vq_assign", 2 * B * N * hq * Q * dv,
              4 * (2 * B * N * hq * dv + hq * Q * dv + B * N * hq))
    return (torch.empty((B, N, hq), dtype=torch.int32, device="meta"),
            torch.empty_like(xh))


def _launch(xh: torch.Tensor, codebook: torch.Tensor):
    """xh: [B, N, hq, dv] f32 contiguous on the card -> (idx [B, N, hq]
    int32, xq [B, N, hq, dv] f32): one kernel launch."""
    require_cuda("vq_assign", xh)
    B, N, hq, dv = xh.shape
    Q = codebook.shape[1]
    dev = xh.device
    if not 1 <= Q <= _QMAX:
        raise ValueError(f"the vq_assign kernel takes 1 <= Q <= {_QMAX}, got Q={Q}")
    if dv < 1:
        raise ValueError("vq_assign needs dv >= 1")
    if B * N >= 2 ** 31 or hq > 65535:
        raise ValueError(f"vq_assign takes B·N < 2^31 tokens and hq <= 65535, "
                         f"got B·N={B * N}, hq={hq}")
    check("xh", xh, (B, N, hq, dv), dev)
    check("codebook", codebook, (hq, Q, dv), dev)
    idx = torch.empty((B, N, hq), dtype=torch.int32, device=dev)
    xq = torch.empty_like(xh)
    if B == 0 or N == 0 or hq == 0:
        return idx, xq
    sched = SCHEDULES.index(schedule(B * N))
    fn = bind("vq_assign", "vq_assign_launch", [PTR] * 4 + [INT] * 5 + [PTR])
    with torch.cuda.device(dev):
        err = fn(xh.data_ptr(), codebook.data_ptr(), idx.data_ptr(), xq.data_ptr(),
                 B * N, hq, Q, dv, sched, stream_of(dev))
    raise_on_error("vq_assign", err)
    LAUNCHES["vq_assign"] += 1
    return idx, xq


def vq_assign(x: torch.Tensor, codebook: torch.Tensor):
    """x: [..., d] attention outputs; codebook: [hq, Q, dv] with hq·dv = d.
    Returns (idx [..., hq] int32, x_q [..., d])."""
    hq, Q, dv = codebook.shape
    *lead, d = x.shape
    if hq * dv != d:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not split d={d}")
    if x.device.type == "cpu":
        idx, xq = vq_assign_ref(x.reshape(*lead, hq, dv), codebook)
        return idx, xq.reshape(*lead, d)
    run = _meta if x.device.type == "meta" else _launch
    idx, xq = run(x.reshape(1, -1, hq, dv).contiguous(), codebook)
    return idx.reshape(*lead, hq), xq.reshape(*lead, d).to(x.dtype)


def vq_assign_batched(x: torch.Tensor, codebook: torch.Tensor):
    """x: [B, N, d] a batch of documents' attention outputs; codebook
    [hq, Q, dv] shared by the batch. Returns (idx [B, N, hq] int32,
    x_q [B, N, d]) — one launch that takes the B·N tokens as one axis."""
    hq, Q, dv = codebook.shape
    B, N, d = x.shape
    if hq * dv != d:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not split d={d}")
    if x.device.type == "cpu":
        idx, xq = vq_assign_ref(x.reshape(B, N, hq, dv), codebook)
        return idx, xq.reshape(B, N, d)
    run = _meta if x.device.type == "meta" else _launch
    idx, xq = run(x.reshape(B, N, hq, dv).contiguous(), codebook)
    return idx, xq.reshape(B, N, d).to(x.dtype)
