"""Wrappers of the fused edit-step kernels (``csrc/fused_step.cu``).

Each wrapper dispatches on the device of its inputs: CPU tensors run the
plain PyTorch version (``ref.py``) — that is how the tests run — and CUDA
tensors launch the hand-written kernel or raise. Nothing falls back from
the card to the plain version. ``LAUNCHES`` counts kernel launches (CPU
calls do not count), so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    FLOAT, INT, PTR, arrival_counts, bind, check, check_aligned, raise_on_error,
    require_cuda, stream_of,
)
from repro_torch.kernels.fused_step.ref import delta_gate_ref, fused_patch_assign_ref

LAUNCHES = {"fused_step": 0, "delta_gate": 0}

_DH = 64  # the head dim and codebook size the kernel is instantiated for
_Q = 64
_ROWS = 64  # rows of a fused_step CTA (csrc/fused_step.cu RT)

# (rows a CTA, burst) of delta_gate launches that ``chip_smoke.py --sweep``
# times at every served r, beside the rule of ``gate_shape``; burst=False
# streams the row (csrc/fused_step.cu delta_gate)
GATE_SHAPES = tuple((rows, burst) for burst in (True, False) for rows in (1, 2, 4, 8))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_patch_assign(q, k_new, k_old, vc_new, vc_old, mask, T_base, counts,
                       vq_bias, *, heads_per_vq: int):
    """One document: q [n, H, dh]; k_* [H, C, dh]; vc_* [H, C, Q]; mask
    [n, C]; T_base [n, H, Q]; counts [n]; vq_bias [hq, Q]. Returns (T_all
    [n, H, Q] f32, codes [n, hq] int32) — the batched kernel's B = 1 view,
    one launch."""
    mask = mask.to(torch.float32)
    if q.device.type == "cpu":
        return fused_patch_assign_ref(q, k_new, k_old, vc_new, vc_old, mask,
                                      T_base, counts, vq_bias)
    T_all, codes = fused_patch_assign_batched(
        *(a[None].contiguous() for a in (q, k_new, k_old, vc_new, vc_old, mask,
                                         T_base, counts)),
        vq_bias, heads_per_vq=heads_per_vq)
    return T_all[0], codes[0]


def fused_patch_assign_batched(q, k_new, k_old, vc_new, vc_old, mask, T_base,
                               counts, vq_bias, *, heads_per_vq: int):
    """q: [B, n, H, dh]; k_*: [B, H, C, dh]; vc_*: [B, H, C, Q];
    mask: [B, n, C] f32 (every gate folded in: live columns, causal order,
    row validity, dirty-row exclusion); T_base: [B, n, H, Q] with the dirty
    rows' full recompute already scattered in; counts: [B, n] f32;
    vq_bias: [hq, Q] shared by the batch.
    Returns (T_all [B, n, H, Q] f32, codes [B, n, hq] int32) — one launch."""
    if q.device.type == "cpu":
        return fused_patch_assign_ref(q, k_new, k_old, vc_new, vc_old, mask,
                                      T_base, counts, vq_bias)
    require_cuda("fused_patch_assign_batched", q)
    B, n, H, dh = q.shape
    C = k_new.shape[2]
    Q = vc_new.shape[-1]
    g = int(heads_per_vq)
    if dh != _DH or Q != _Q:
        raise ValueError(f"the fused_step kernel takes dh=Q=64, got dh={dh} Q={Q}")
    if g < 1 or H % g:
        raise ValueError(f"heads_per_vq={g} does not divide H={H}")
    dev = q.device
    check("q", q, (B, n, H, dh), dev)
    for name, t in (("k_new", k_new), ("k_old", k_old)):
        check(name, t, (B, H, C, dh), dev)
    for name, t in (("vc_new", vc_new), ("vc_old", vc_old)):
        check(name, t, (B, H, C, Q), dev)
    check("mask", mask, (B, n, C), dev)
    check("T_base", T_base, (B, n, H, Q), dev)
    check("counts", counts, (B, n), dev)
    check("vq_bias", vq_bias, (H // g, Q), dev)
    check_aligned(q=q, k_new=k_new, k_old=k_old, vc_new=vc_new, vc_old=vc_old,
                  T_base=T_base)
    T_all = torch.empty_like(T_base)
    codes = torch.empty((B, n, H // g), dtype=torch.int32, device=dev)
    if B == 0 or n == 0:
        return T_all, codes
    fn = bind("fused_step", "fused_step_launch", [PTR] * 12 + [INT] * 5 + [FLOAT, PTR])
    # one count per (document, row tile, vq head)
    arrived = arrival_counts(dev, B * -(-n // _ROWS) * (H // g))
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_new.data_ptr(), k_old.data_ptr(),
                 vc_new.data_ptr(), vc_old.data_ptr(), mask.data_ptr(),
                 T_base.data_ptr(), counts.data_ptr(), vq_bias.data_ptr(),
                 T_all.data_ptr(), codes.data_ptr(), arrived.data_ptr(), B, n, H,
                 C, g, float(dh ** -0.5), stream_of(dev))
    raise_on_error("fused_step", err)
    LAUNCHES["fused_step"] += 1
    return T_all, codes


def gate_shape(r: int) -> tuple[int, bool]:
    """(rows a CTA, burst) of the delta_gate launch for r rows, from
    ``chip_smoke.py --sweep`` at d=768 (PERF.md §6, delta_gate): bursts
    over as many CTAs as leave the card mostly idle, then streamed rows, 8
    a CTA."""
    if r <= 512:
        return min(4, max(1, r // 64)), True
    return 8, False


def delta_gate(x_new, x_old, threshold: float):
    """Sigma-delta propagation gate: keep[i] = max_d |x_new[i] − x_old[i]| >
    threshold (strict). x_new/x_old: [r, d] f32; returns keep [r] bool,
    bitwise equal to ``delta_gate_ref``."""
    if x_new.device.type == "cpu":
        return delta_gate_ref(x_new, x_old, threshold)
    require_cuda("delta_gate", x_new)
    if x_new.dim() != 2:
        raise ValueError(f"delta_gate takes [r, d] rows, got {tuple(x_new.shape)}")
    r, d = x_new.shape
    check("x_new", x_new, (r, d), x_new.device)
    check("x_old", x_old, (r, d), x_new.device)
    keep = torch.empty((r,), dtype=torch.bool, device=x_new.device)
    if r == 0:
        return keep
    if d == 0:
        raise ValueError("delta_gate needs d >= 1")
    rows, burst = gate_shape(r)
    fn = bind("fused_step", "delta_gate_launch",
              [PTR, PTR, PTR, INT, INT, FLOAT, INT, INT, PTR])
    with torch.cuda.device(x_new.device):
        err = fn(x_new.data_ptr(), x_old.data_ptr(), keep.data_ptr(), r, d,
                 float(threshold), rows, int(burst), stream_of(x_new.device))
    raise_on_error("delta_gate", err)
    LAUNCHES["delta_gate"] += 1
    return keep
