"""Wrappers of the incremental column-patch kernel (``csrc/incr_patch.cu``),
the port of ``repro/kernels/incr_patch/ops.py``.

``incr_patch`` patches one document (the kernel with B = 1) and
``incr_patch_batched`` a [B] batch in one launch. ``row_valid`` (the slot
buffer's valid rows) is folded into the mask before the launch, so free or
deleted slots receive an exactly-zero patch. CPU tensors run the plain
version (``ref.py``); CUDA tensors launch the kernel or raise. ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.common.bucketing import next_pow2
from repro_torch.kernels._launch import (
    FLOAT, INT, PTR, arrival_counts, bind, check, check_aligned, raise_on_error,
    require_cuda, stream_of,
)
from repro_torch.kernels.incr_patch.ref import incr_patch_ref

LAUNCHES = {"incr_patch": 0}

_DH = 64  # the head dim and codebook size the kernel is instantiated for
_Q = 64
_ROWS = 64  # rows of a CTA (csrc/patch_tile.cuh RT)


def bucket_capacity(n: int, minimum: int = 8) -> int:
    """The power-of-two capacity bucket of ``n`` dirty columns (at least
    ``minimum``): each bucket is one step shape."""
    return next_pow2(n, minimum)


def split(B: int, R: int, H: int, C: int) -> bool:
    """Whether each (row tile, head, document) takes two CTAs of the kernel,
    one a product (new or old), instead of one CTA for both. The result is
    the same to the bit either way. Two are faster from 5 column tiles of 32
    on, and from 3 tiles while the grid holds at most 384 (row tile, head,
    document) triples; with 1 or 2 tiles they are slower (H100, PERF.md)."""
    tiles = -(-C // 32)
    return tiles >= 5 or (tiles >= 3 and B * -(-R // _ROWS) * H <= 384)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(q, k_new, k_old, vc_new, vc_old, mask):
    """The batched layout on the card -> ΔT [B, R, H, Q] f32, one launch."""
    require_cuda("incr_patch", q)
    B, R, H, dh = q.shape
    C = k_new.shape[2]
    Q = vc_new.shape[-1]
    if dh != _DH or Q != _Q:
        raise ValueError(f"the incr_patch kernel takes dh=Q=64, got dh={dh} Q={Q}")
    dev = q.device
    check("q", q, (B, R, H, dh), dev)
    for name, t in (("k_new", k_new), ("k_old", k_old)):
        check(name, t, (B, H, C, dh), dev)
    for name, t in (("vc_new", vc_new), ("vc_old", vc_old)):
        check(name, t, (B, H, C, Q), dev)
    check("mask", mask, (B, R, C), dev)
    check_aligned(q=q, k_new=k_new, k_old=k_old, vc_new=vc_new, vc_old=vc_old)
    out = torch.empty((B, R, H, Q), dtype=torch.float32, device=dev)
    if B == 0 or R == 0 or H == 0:
        return out
    fn = bind("incr_patch", "incr_patch_launch", [PTR] * 9 + [INT] * 5 + [FLOAT, PTR])
    two = split(B, R, H, C)
    part = torch.empty_like(out) if two else out  # dT_old of a split pair
    # one count per (document, row tile, head)
    arrived = arrival_counts(dev, B * -(-R // _ROWS) * H)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_new.data_ptr(), k_old.data_ptr(), vc_new.data_ptr(),
                 vc_old.data_ptr(), mask.data_ptr(), out.data_ptr(), part.data_ptr(),
                 arrived.data_ptr(), B, R, H, C, int(two), float(dh ** -0.5),
                 stream_of(dev))
    raise_on_error("incr_patch", err)
    LAUNCHES["incr_patch"] += 1
    return out


def _fold_rows(mask, row_valid):
    mask = mask.to(torch.float32)
    if row_valid is not None:
        mask = mask * row_valid.to(torch.float32)[..., None]
    return mask


def incr_patch(q, k_new, k_old, vc_new, vc_old, mask, *, row_valid=None):
    """q: [R, H, dh]; k_*: [H, C, dh]; vc_*: [H, C, Q]; mask: [R, C];
    row_valid: [R] or None. Returns ΔT [R, H, Q] f32."""
    mask = _fold_rows(mask, row_valid)
    if q.device.type == "cpu":
        return incr_patch_ref(q, k_new, k_old, vc_new, vc_old, mask)
    return _launch(*(a[None].contiguous() for a in
                     (q, k_new, k_old, vc_new, vc_old, mask)))[0]


def incr_patch_batched(q, k_new, k_old, vc_new, vc_old, mask, *, row_valid=None):
    """Every argument with a leading document axis: q [B, R, H, dh];
    k_* [B, H, C, dh]; vc_* [B, H, C, Q]; mask [B, R, C]; row_valid [B, R]
    or None. Returns ΔT [B, R, H, Q] f32 — one launch."""
    mask = _fold_rows(mask, row_valid)
    if q.device.type == "cpu":
        return incr_patch_ref(q, k_new, k_old, vc_new, vc_old, mask)
    return _launch(q, k_new, k_old, vc_new, vc_old, mask.contiguous())
