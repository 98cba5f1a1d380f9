"""Wrappers of the fused edit-step kernels (``csrc/fused_step.cu``).

Each wrapper dispatches on the device of its inputs: CPU tensors run the
plain PyTorch version (``ref.py``) — that is how the tests run — and CUDA
tensors launch the hand-written kernel or raise. Nothing falls back from
the card to the plain version. ``LAUNCHES`` counts kernel launches (CPU
calls do not count), so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.fused_step.ref import delta_gate_ref, fused_patch_assign_ref

LAUNCHES = {"fused_step": 0, "delta_gate": 0}

_DH = 64  # the head dim and codebook size the kernel is instantiated for
_Q = 64
_fns: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from repro_torch.kernels import _build

        lib = _build.load("fused_step")
        fn = getattr(lib, name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "fused_step_launch":
            fn.argtypes = [p] * 11 + [i] * 5 + [f, p]
        else:
            fn.argtypes = [p, p, p, i, i, f, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


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
    if q.device.type != "cuda":
        raise ValueError(f"fused_patch_assign_batched: no kernel for {q.device}")
    B, n, H, dh = q.shape
    C = k_new.shape[2]
    Q = vc_new.shape[-1]
    g = int(heads_per_vq)
    if dh != _DH or Q != _Q:
        raise ValueError(f"the fused_step kernel takes dh=Q=64, got dh={dh} Q={Q}")
    if g < 1 or H % g:
        raise ValueError(f"heads_per_vq={g} does not divide H={H}")
    dev = q.device
    _check("q", q, (B, n, H, dh), dev)
    for name, t in (("k_new", k_new), ("k_old", k_old)):
        _check(name, t, (B, H, C, dh), dev)
    for name, t in (("vc_new", vc_new), ("vc_old", vc_old)):
        _check(name, t, (B, H, C, Q), dev)
    _check("mask", mask, (B, n, C), dev)
    _check("T_base", T_base, (B, n, H, Q), dev)
    _check("counts", counts, (B, n), dev)
    _check("vq_bias", vq_bias, (H // g, Q), dev)
    T_all = torch.empty_like(T_base)
    codes = torch.empty((B, n, H // g), dtype=torch.int32, device=dev)
    if B == 0 or n == 0:
        return T_all, codes
    fn = _lib_fn("fused_step_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_new.data_ptr(), k_old.data_ptr(),
                 vc_new.data_ptr(), vc_old.data_ptr(), mask.data_ptr(),
                 T_base.data_ptr(), counts.data_ptr(), vq_bias.data_ptr(),
                 T_all.data_ptr(), codes.data_ptr(), B, n, H, C, g,
                 float(dh ** -0.5), stream)
    _launch_error("fused_step", err)
    LAUNCHES["fused_step"] += 1
    return T_all, codes


def delta_gate(x_new, x_old, threshold: float):
    """Sigma-delta propagation gate: keep[i] = max_d |x_new[i] − x_old[i]| >
    threshold (strict). x_new/x_old: [r, d] f32; returns keep [r] bool,
    bitwise equal to ``delta_gate_ref``."""
    if x_new.device.type == "cpu":
        return delta_gate_ref(x_new, x_old, threshold)
    if x_new.device.type != "cuda":
        raise ValueError(f"delta_gate: no kernel for {x_new.device}")
    if x_new.dim() != 2:
        raise ValueError(f"delta_gate takes [r, d] rows, got {tuple(x_new.shape)}")
    r, d = x_new.shape
    _check("x_new", x_new, (r, d), x_new.device)
    _check("x_old", x_old, (r, d), x_new.device)
    keep = torch.empty((r,), dtype=torch.bool, device=x_new.device)
    if r == 0:
        return keep
    if d == 0:
        raise ValueError("delta_gate needs d >= 1")
    fn = _lib_fn("delta_gate_launch")
    with torch.cuda.device(x_new.device):
        stream = torch.cuda.current_stream(x_new.device).cuda_stream
        err = fn(x_new.data_ptr(), x_old.data_ptr(), keep.data_ptr(), r, d,
                 float(threshold), stream)
    _launch_error("delta_gate", err)
    LAUNCHES["delta_gate"] += 1
    return keep
