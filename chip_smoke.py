#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--sweep [NAMES]]

Phases, one JSON line each with the seconds it took (any failure raises
and exits non-zero):

1. device     — the card's name and power limit (nvidia-smi), CUDA version;
                TF32 off for matmuls and cuDNN (TF32 flips VQ codes).
2. build      — nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a into
                ``build/repro_torch_kernels/``; ptxas's registers and spills
                and the md5 of each kernel function's SASS.
3. kernels    — every kernel against its plain version on the card at the
                main paths' shapes, then timed with CUDA events (median of
                25 after warm-up) and with torch.profiler (device time per
                call): ``fused_step`` (B=4, n=1024, H=12, dh=Q=64, hq=2, C in
                {8, 72, 264} with a random mask and C=72 with the engine's
                causal one; the kernel's own device time by name beside the
                call's), ``delta_gate`` (d=768, r from 64 to 2048: the
                served row counts; keep bits equal) beside the launch floor
                (a one-element ``zero_()``), ``vq_assign`` (hq=2,
                Q=64, dv=384; B=4 x N=1024, N=1024, N=32 and N=1: idx
                equal away from near-ties, x_q bitwise the codebook row; the
                VQ kernel's own device time by name beside the wrapper's),
                ``gated_attention`` (BH=48, dh=64, n in {1024, 1000, 37},
                within 1e-5; its bound at its route's peak, 3xTF32 on
                the tensor cores, beside the FP32 cores') and ``incr_patch`` (B=4, n=1024, H=12, C in
                {8, 72, 264}, and 1x1024x1032, the most served step; within
                1e-4, all-masked rows exactly 0).
4. serve      — full-width VQ-OPT-125M (random weights from seed 0) behind
                ``BatchServer(device="cuda")``: 4 documents (256, 300, 700
                and 1000 tokens) and a seeded mixed edit stream that forces
                a grow, a defrag and an overflow fallback; tokens must equal
                a host replay, logits must be finite, and ``fused_step`` must
                launch 12 times per edit dispatch; a census of the (B, n, C)
                shapes its calls ran at (also in the profiled rounds).
5. parity     — the same stream through ``use_fused_kernel=False``: equal
                tokens, counters and codes, logits within 1e-3 (a code may
                differ only at a near-tie, top-two scores within 1e-5).
6. threshold  — the same stream at ``delta_threshold=1.0``: exact tokens,
                ``delta_gate`` launched, a census of the row counts r it
                ran at; then the profile phase's round of edits under
                torch.profiler (``delta_gate``'s device time, launches and
                share of the busy time).
7. patch      — the serve stream through ``use_fused_kernel=False,
                use_patch_kernel=True``: tokens and counters equal the
                fused server's, codes equal except at near-ties, logits
                within 1e-3, 12 ``incr_patch`` launches per edit dispatch;
                then the profile phase's round of edits under torch.profiler
                (``incr_patch`` device time and launches).
8. profile    — one more round of edits on the served fleet under
                torch.profiler: device busy time against wall time, and the
                kernels that take it.
9. forward    — ``models.transformer.forward`` on the 4 documents padded to
                a [4, 1024] batch with their sampled position ids: each
                document's last-row logits within 1e-3 of the engine's
                ``full_forward`` + ``logits_at`` (unless a VQ code flipped
                at a near-tie), 12 ``gated_attention`` and 12 ``vq_assign``
                launches per call, ms per call and tokens/s; then one call
                under torch.profiler: device busy time, ``gated_attention``'s
                device time over its launches, the 5 kernels that take the
                most.
10. suggest   — the 4 documents subscribed to 8-token suggestions, then
                the serve stream plus 6 appends to the 1000-token document
                (its continuation runs out of position ids: a defrag and a
                retry), then one profiled round (a replace per document).
                After every flush each suggestion equals
                ``oracle_suggestion`` token for token, or differs first
                where the oracle's top-two logits lie within 1e-4.
                ``vq_assign`` must launch inside the (unprofiled) flushes;
                refresh latency, reuse counts, decode-cache bytes, peak
                memory, and the profiled round's device busy share.
11. tiered    — the serve stream's first 3 rounds with 8-token suggestions
                on all 4 documents through ``BatchServer(max_batch=2)`` whose
                device budget holds two 1024-capacity states (and half a
                third, for one decode cache) and whose host budget holds one
                (``tiered_budgets``; cold spills under a temporary
                directory), against an unbudgeted server on the same stream:
                evictions, spills, rehydrations and a dropped suggestion
                cache must occur; tokens, every suggestion, every state leaf
                and ``logits()`` bitwise equal; 12 ``fused_step`` launches a
                dispatch; the stats reconcile with a recount of the store;
                one forced ``evict(..., "warm")`` frees at least the state's
                bytes of ``memory_allocated``; one document through
                ``checkpoint_document`` -> ``export_document`` ->
                ``import_document`` into a second server with bitwise
                logits. Prints the hot-hit rate, bytes per tier, peak memory
                beside the budget and the weights.
12. async     — ``AsyncBatchServer(max_batch_delay_ms=8)`` over the budgeted
                server: one client thread per document submits its share of
                the stream's first 2 rounds, waits for a suggestion after
                each, and streams its subscription; every suggestion and
                the final tokens equal a sequential ``BatchServer`` fed each
                document's requests in order, and streamed token events
                reassemble into each streamed continuation. Prints edit and
                suggestion latency (p50, p99, max) and edits per round.
13. fleet     — ``FleetRouter`` with 2 replica workers on the card (full
                width, seed 0) and the 4 documents: the 256-token document
                alone takes its round-0 edits (a grow), migrates, takes 16
                inserts at one position (a defrag); its logits are bitwise
                equal to an in-process server's and its suggestions
                token-exact around the move; the router's stats reconcile
                with the replicas' and the acked edits; after a checkpoint,
                one replica is killed with edits in flight and every
                document resumes token-exact on the survivor; the fleet
                closes leaving no child process and no cold file. Prints
                the workers' boot seconds, the migration's and the
                failover's ms and the router's stats.

Then the card's name and power limit, one ``{"kernels": [...]}`` line
(``delta_gate`` at the threshold phase's most served r), and the last line
``{"ok": true, "device": {...}}``. The launch counts in the
kernels line come from the path that runs each kernel (serve for
``fused_step``, threshold for ``delta_gate``, forward for
``gated_attention``, the suggest flushes for ``vq_assign``, patch for
``incr_patch``), with the counters set to 0 just before that path; launches
made to compare or time a kernel do not count. Exits non-zero without a GPU
and outside a checkout of the repo.

``--sweep`` runs phases 1 and 2, then times the launch floor and
``delta_gate`` at r in {64, ..., 4096} (d=768) under the wrapper's launch
shape and with each of ``ops.GATE_SHAPES`` (rows a CTA, burst or
stream) forced, ``vq_assign`` at 1 to 4,096
tokens under the wrapper's schedule rule and with each schedule forced (the
numbers behind the rule), and ``fused_step`` and ``incr_patch``, each
against its plain version, at every (B, n, C) the serve phase's edit steps
run at (B in {1, 2, 4}, n=1024, C in {8, 72, 136, 264}; 1x1024x520 and
1x1024x1032) and at 1x4096x72, ``incr_patch`` also with each of its two
layouts forced, and ``gated_attention`` against its plain version at
BH=48 x n in {37, 128, 256, 512, 1000, 1024, 2048}, BH=12 x n=1024 and
BH=48 at (nq, nk) = (1024, 512) and (512, 1024), with both bounds; one
line a shape, and prints no ok line. ``--sweep delta_gate,patch`` runs only
the named sweeps (of ``delta_gate``, ``vq_assign``, ``patch``,
``gated_attention``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
# gated_attention's route: each f32 product as three TF32 tensor-core products
GA_CORES, GA_PEAK, GA_PRODUCTS = "tensor-core-3xtf32", TF32_FLOPS_PER_S, 3
DEVICE = "cuda"
DOC_LENGTHS = {"d256": 256, "d300": 300, "d700": 700, "d1000": 1000}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, iters: int = 25, tries: int = 3) -> dict:
    """Mean device milliseconds per call of each CUDA kernel (and copy)
    torch.profiler traced over ``iters`` calls, by kernel name, without the
    host's launch gaps. A trace now and then misses some or all of the
    device records, so up to ``tries`` traces are taken until one holds
    every kernel a whole number of times per call; else the last that holds
    any. Empty when none holds device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        out = {e.key: e.self_device_time_total / iters / 1e3 for e in events} or out
        if events and all(e.count % iters == 0 for e in events):
            break
    return out


def timings(fn, kernel: str | None = None) -> dict:
    """``ms``: device time per call from the profiler trace (every kernel
    the call launches), or the event time when the trace holds none;
    ``call_ms``: CUDA-event time around one call, which includes the host's
    wrapper work when that is the longer. With ``kernel``, also
    ``kernel_ms``: the device time of the kernels whose name holds it, and
    ``kernels``: their names."""
    call = time_ms(fn)
    by_name = device_ms(fn)
    out = dict(ms=sum(by_name.values()) if by_name else call, call_ms=call,
               timing="profiler" if by_name else "events")
    if kernel is not None:
        mine = {k.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "): v
                for k, v in by_name.items() if kernel in k}
        out["kernel_ms"] = sum(mine.values()) or None
        out["kernels"] = sorted(mine)
    return out


def bound(nbytes: float, flops: float,
          peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the peak of the units that run them
    (the FP32 CUDA cores unless the kernel's route names others)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ kernels


def engine_mask(gen, B: int, n: int, C: int, lengths=(256, 300, 700, 1000)):
    """A patch mask built as the engine builds it (``jit_engine``'s fused
    step): column c is the slot ``col[b, c]`` (sorted, as the engine's
    lowest-slot-first pick), live where its position id is at most the
    row's (causal order), times row validity (the document's length),
    times not dirty (the first C - 8 columns are the changed rows, whose
    full recompute is in ``T_base``). Positions are sorted sampled ids, so
    whole (row tile, column tile) pairs above the diagonal are zero. The
    last document is a dispatch's filler: all zero."""
    dev = torch.device("cuda")
    mask = torch.zeros((B, n, C), device=dev)
    for b in range(B - 1):
        length = min(lengths[b % len(lengths)], n)
        pos = torch.randperm(4 * n, generator=gen, device=dev)[:n].sort().values
        col = torch.randperm(length, generator=gen, device=dev)[:C].sort().values
        if col.numel() < C:  # fewer slots than columns: repeat the last
            col = torch.cat([col, col[-1:].expand(C - col.numel())])
        row_valid = (torch.arange(n, device=dev) < length).float()
        dirty = torch.zeros(n, device=dev)
        dirty[col[:max(C - 8, 0)]] = 1.0
        causal = (pos[col][None, :] <= pos[:, None]).float()
        mask[b] = causal * (row_valid * (1.0 - dirty))[:, None]
    return mask


def check_fused_step(ops, ref, gen, C: int, B=4, n=1024, H=12, dh=64, Q=64, hq=2,
                     causal: bool = False):
    """``fused_patch_assign_batched`` against the plain version: T within
    1e-4 (rtol 1e-5), codes equal away from near-ties, fully masked rows
    bitwise ``T_base`` (sign bits of -0.0 included). The mask is random
    (~38% live; every 7th row and, for B > 1, the last document dead) or,
    with ``causal``, the engine's."""
    dev = torch.device("cuda")
    g = H // hq
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k_new, k_old = randn(B, n, H, dh), randn(B, H, C, dh), randn(B, H, C, dh)
    vc_new, vc_old = randn(B, H, C, Q), randn(B, H, C, Q)
    if causal:
        mask = engine_mask(gen, B, n, C)
    else:
        mask = (torch.rand((B, n, C), generator=gen, device=dev) < 0.6).float()
        mask[:, ::7] = 0.0  # fully masked rows (dirty rows, free slots)
        if B > 1:
            mask[B - 1] = 0.0  # a dispatch's filler document
    T_base = randn(B, n, H, Q)
    T_base[:, ::5, :, :3] = -0.0  # a dead row must keep its sign bits
    counts = torch.randint(1, n + 1, (B, n), generator=gen, device=dev).float()
    vq_bias = randn(hq, Q)
    args = (q, k_new, k_old, vc_new, vc_old, mask, T_base, counts, vq_bias)
    T_k, codes_k = ops.fused_patch_assign_batched(*args, heads_per_vq=g)
    T_p, codes_p = ref.fused_patch_assign_ref(*args)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    if not torch.allclose(T_k, T_p, atol=1e-4, rtol=1e-5):
        raise AssertionError(f"fused_step C={C}: T differs by {err} (atol 1e-4, rtol 1e-5)")
    s = T_p.reshape(B, n, hq, g, Q).sum(3) / counts[..., None, None] + vq_bias
    top2 = s.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-5
    flips = codes_k != codes_p
    if (flips & ~near).any():
        raise AssertionError(
            f"fused_step C={C}: {int((flips & ~near).sum())} codes differ away from near-ties")
    dead = mask.sum(-1) == 0  # [B, n]
    if not torch.equal(T_k[dead].view(torch.int32), T_base[dead].view(torch.int32)):
        raise AssertionError(f"fused_step C={C}: fully masked rows are not bitwise T_base")
    kernel = timings(lambda: ops.fused_patch_assign_batched(*args, heads_per_vq=g),
                     kernel="fused_step")
    plain = timings(lambda: ref.fused_patch_assign_ref(*args))
    live = float(mask.sum())
    nbytes = 4 * (sum(a.numel() for a in args) + T_k.numel() + codes_k.numel())
    flops = live * H * (4 * dh + 4 * Q) + 2 * B * n * H * Q + 2 * B * n * hq * Q
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(B=B, n=n, C=C, mask="causal" if causal else "random",
                max_abs_err=err, near_tie_rows=int(near.sum()),
                near_tie_flips=int(flips.sum()), masked_rows=int(dead.sum()),
                ms=kernel["ms"], kernel_ms=kernel["kernel_ms"], call_ms=kernel["call_ms"],
                plain_ms=plain["ms"], plain_call_ms=plain["call_ms"],
                timing=kernel["timing"], bound_ms=bound_ms, bound_by=bound_by,
                live_mask_fraction=live / mask.numel())


def gate_work(r: int, d: int) -> tuple[int, int]:
    """The compulsory bytes (x_new and x_old read once, one keep byte a row
    written) and operations (a subtract, an abs and a max an element) of
    ``delta_gate`` on r rows of d floats."""
    return 4 * 2 * r * d + r, 3 * r * d


def gate_edge_rows(x_new, x_old, threshold: float) -> list[bool]:
    """Write the gate's edge cases into the first 9 rows of x_new / x_old
    ([r >= 9, d >= 2] f32, threshold >= 0) and return their keep bits:
    a change of exactly the threshold (as f32) and one ulp above it; an
    unchanged row; a NaN in x_new and one in x_old beside a large change
    (torch.amax propagates NaN, and NaN > t is False); +inf against +inf
    (NaN) beside a large change; -0.0 against 0.0; +inf against a finite
    value; -inf against +inf."""
    t = torch.tensor(threshold, dtype=torch.float32)
    inf, big = float("inf"), 10 * threshold + 10
    x_new[:2], x_old[:2] = 0.0, 0.0
    x_new[0, 0], x_new[0, 1] = t, -t
    x_new[1, 0] = torch.nextafter(t, torch.tensor(inf))
    x_new[2:9] = x_old[2:9]
    x_new[3, 0], x_new[3, 1] = float("nan"), x_old[3, 1] + big
    x_old[4, -1], x_new[4, 0] = float("nan"), x_old[4, 0] + big
    x_new[5, 0] = x_old[5, 0] = inf
    x_new[5, 1] = x_old[5, 1] + big
    x_new[6], x_old[6] = -0.0, 0.0
    x_new[7, 0] = inf
    x_new[8, -1], x_old[8, -1] = -inf, inf
    return [False, True, False, False, False, False, False, True, True]


def check_delta_gate(ops, ref, gen, r: int, d: int = 768, threshold: float = 1.0,
                     timed: bool = False, plain: bool = True):
    """``delta_gate`` against the plain version: keep bits equal, and the
    edge rows of ``gate_edge_rows`` as it says. With ``timed``, the
    kernel's device and call times (and, with ``plain``, the plain
    version's) beside the bound."""
    dev = torch.device("cuda")
    x_old = torch.randn((r, d), generator=gen, device=dev)
    x_new = x_old + (torch.rand((r, d), generator=gen, device=dev) * 2 - 1) * 1.2
    edge = torch.tensor(gate_edge_rows(x_new, x_old, threshold), device=dev)
    keep = ops.delta_gate(x_new, x_old, threshold)
    want = ref.delta_gate_ref(x_new, x_old, threshold)
    torch.cuda.synchronize()
    if not torch.equal(keep, want) or not torch.equal(keep[:len(edge)], edge):
        raise AssertionError(f"delta_gate r={r}: keep bits differ from the plain version")
    err = float((keep.float() - want.float()).abs().max())
    out = dict(r=r, d=d, kept=int(keep.sum()), max_abs_err=err)
    if timed:
        kernel = timings(lambda: ops.delta_gate(x_new, x_old, threshold), kernel="delta_gate")
        out.update(ms=kernel["ms"], kernel_ms=kernel["kernel_ms"],
                   call_ms=kernel["call_ms"], timing=kernel["timing"])
        if plain:
            base = timings(lambda: ref.delta_gate_ref(x_new, x_old, threshold))
            out.update(plain_ms=base["ms"], plain_call_ms=base["call_ms"])
        out["bound_ms"], out["bound_by"] = bound(*gate_work(r, d))
    return out


def launch_floor() -> dict:
    """What the card takes for the least kernel: a one-element ``zero_()``,
    its device time under torch.profiler and its CUDA-event call time."""
    z = torch.empty(1, device="cuda")
    t = timings(z.zero_)
    return dict(ms=t["ms"], call_ms=t["call_ms"], timing=t["timing"])


# the r = B x min(R, n) the threshold phase's gate sees at d=768 (R doubles
# from 64 on overflow), then 4096
SWEEP_GATE = (64, 128, 256, 512, 1024, 2048, 4096)


def sweep_delta_gate(ops, ref, gen) -> None:
    """``--sweep``: the launch floor, then ``delta_gate`` (d=768) at each r
    of SWEEP_GATE under the wrapper's rule (kernel, call, plain and bound)
    and with each (rows a CTA, burst or stream) of ``ops.GATE_SHAPES``
    forced, every call first held against the plain version. One JSON line
    a row count."""
    emit("sweep", kernel="launch_floor", **launch_floor())
    rule = getattr(ops, "gate_shape", None)  # None in a tree with one launch shape
    for r in SWEEP_GATE:
        row = dict(kernel="delta_gate", r=r, shape=rule(r) if rule else None,
                   rule=check_delta_gate(ops, ref, gen, r, timed=True))
        shapes = {}
        for rows, burst in getattr(ops, "GATE_SHAPES", ()):
            with mock.patch.object(ops, "gate_shape", lambda _r, _s=(rows, burst): _s):
                shapes[f"{rows}x{'burst' if burst else 'stream'}"] = check_delta_gate(
                    ops, ref, gen, r, timed=True, plain=False)["ms"]
        emit("sweep", **row, shapes_ms=shapes)


def check_vq_assign(mod, gen, B: int, N: int, hq=2, Q=64, dv=384):
    """``vq_assign`` (B = 1) or ``vq_assign_batched`` against the plain
    version: indices equal except where the plain version's top-two scores
    lie within 1e-4 (the dot products sum in another order), x_q bitwise
    the codebook row of the kernel's index. ``max_abs_err`` is over every
    entry of x_q, so a near-tie flip shows in it as a whole codebook row."""
    dev = torch.device("cuda")
    x = torch.randn((B, N, hq * dv), generator=gen, device=dev)
    cb = torch.randn((hq, Q, dv), generator=gen, device=dev) * 0.5
    call = ((lambda: mod.vq_assign(x[0], cb)) if B == 1
            else (lambda: mod.vq_assign_batched(x, cb)))
    idx, xq = call()
    idx = idx.reshape(B, N, hq)
    idx_p, xq_p = mod.vq_assign_ref(x.reshape(B, N, hq, dv), cb)
    torch.cuda.synchronize()
    s = (torch.einsum("bnhd,hqd->bnhq", x.reshape(B, N, hq, dv), cb)
         + mod.codebook_bias(cb))
    top2 = s.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= 1e-4
    flips = idx != idx_p
    if (flips & ~near).any():
        raise AssertionError(f"vq_assign B={B} N={N}: {int((flips & ~near).sum())} "
                             "indices differ away from near-ties")
    heads = torch.arange(hq, device=dev)
    if not torch.equal(xq.reshape(B, N, hq, dv), cb[heads, idx.long()]):
        raise AssertionError(f"vq_assign B={B} N={N}: x_q is not bitwise C[idx]")
    xq = xq.reshape(B, N, hq, dv)
    if not torch.equal(xq[~flips], xq_p[~flips]):
        raise AssertionError(f"vq_assign B={B} N={N}: x_q differs from the plain version")
    err = float((xq - xq_p).abs().max())
    kernel = timings(call, kernel="vq_assign_")
    plain = timings(lambda: mod.vq_assign_ref(x.reshape(B, N, hq, dv), cb))
    nbytes = 4 * (2 * x.numel() + cb.numel() + B * N * hq)
    bound_ms, bound_by = bound(nbytes, 2 * B * N * hq * Q * dv)
    return dict(B=B, N=N, kernels=kernel["kernels"], max_abs_err=err,
                near_tie_rows=int(near.sum()), near_tie_flips=int(flips.sum()),
                ms=kernel["ms"], kernel_ms=kernel["kernel_ms"],
                call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                bound_ms=bound_ms, bound_by=bound_by)


SWEEP_TOKENS = (1, 32, 128, 256, 384, 512, 1024, 1536, 2048, 4096)
SWEEP_SCHEDULES = ("small", "large16", "large32")  # vq_assign/ops.py SCHEDULES


def sweep_vq_assign(mod, gen) -> None:
    """``--sweep``: ``vq_assign`` (hq=2, Q=64, dv=384) at each of
    SWEEP_TOKENS tokens under the wrapper's schedule rule and with each
    schedule forced, every call first held against the plain version as in
    the kernels phase; one JSON line a token count."""
    for n in SWEEP_TOKENS:
        row = dict(N=n, rule=check_vq_assign(mod, gen, 1, n))
        for name in SWEEP_SCHEDULES:
            with mock.patch.object(mod.ops, "schedule", lambda _t, _n=name: _n, create=True):
                row[name] = check_vq_assign(mod, gen, 1, n)
        emit("sweep", **row)


# every (B, n, C) the serve phase's edit steps run at (PERF.md §5), then
# n=4096; 1x1024x1032 is the most served step
SWEEP_PATCH = (tuple((B, 1024, C) for B in (1, 2, 4) for C in (8, 72, 136, 264))
               + ((1, 1024, 520), (1, 1024, 1032), (1, 4096, 72)))


def sweep_patch(ops, ref, ipk, gen) -> None:
    """``--sweep``: ``fused_step`` (H=12, hq=2) and ``incr_patch`` (H=12) at
    each (B, n, C) of SWEEP_PATCH with the same random mask law, each
    against its plain version, each call first held against the plain
    version as in the kernels phase; ``incr_patch`` under the wrapper's
    layout rule and with each layout forced (the numbers behind
    ``ops.split``). One JSON line a shape."""
    rule = getattr(ipk.ops, "split", None)  # None in a tree with one layout
    for B, n, C in SWEEP_PATCH:
        fused = check_fused_step(ops, ref, gen, C, B=B, n=n)
        patch = check_incr_patch(ipk, gen, C, B=B, n=n)
        layouts = {}
        for name, two in (("one_cta", False), ("cta_per_product", True)):
            with mock.patch.object(ipk.ops, "split", lambda *_a, _two=two: _two,
                                   create=True):
                layouts[name] = check_incr_patch(ipk, gen, C, B=B, n=n)["kernel_ms"]
        emit("sweep", B=B, n=n, C=C, fused_step=fused, incr_patch=patch,
             incr_patch_split=rule(B, n, 12, C) if rule else None,
             incr_patch_layout_ms=layouts,
             incr_patch_over_fused_step=patch["ms"] / fused["ms"])


def attention_work(BH: int, nq: int, nk: int, dh: int = 64) -> tuple[int, int]:
    """The compulsory bytes (q, k and v read once, O written once) and FP32
    operations (2 a multiply-add, q k^T and W v; GELUs not counted) of
    causal attention, where row i attends min(i + 1, nk) keys."""
    pairs = sum(min(i + 1, nk) for i in range(nq))  # (query, key) pairs a bh
    return 4 * 2 * BH * (nq + nk) * dh, BH * pairs * 4 * dh


def check_gated_attention(mod, gen, nq: int, nk: int | None = None, BH=48, dh=64):
    """``gated_attention_bh`` against the plain version, within 1e-5; the
    bound of the kernel's route (``bound_ms``) and of the FP32 CUDA cores."""
    nk = nq if nk is None else nk
    dev = torch.device("cuda")
    q = torch.randn((BH, nq, dh), generator=gen, device=dev) * 0.5
    k = torch.randn((BH, nk, dh), generator=gen, device=dev) * 0.5
    v = torch.randn((BH, nk, dh), generator=gen, device=dev)
    out = mod.gated_attention_bh(q, k, v)
    want = mod.gated_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    if err > 1e-5:
        raise AssertionError(f"gated_attention {BH}x{nq}x{nk}: differs by {err} (atol 1e-5)")
    kernel = timings(lambda: mod.gated_attention_bh(q, k, v), kernel="gated_attention")
    plain = timings(lambda: mod.gated_attention_ref(q, k, v))
    nbytes, flops = attention_work(BH, nq, nk, dh)
    bound_ms, bound_by = bound(nbytes, GA_PRODUCTS * flops, GA_PEAK)
    return dict(BH=BH, nq=nq, nk=nk, max_abs_err=err, ms=kernel["ms"],
                kernel_ms=kernel["kernel_ms"], kernels=kernel["kernels"],
                call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                cores=GA_CORES, bound_ms=bound_ms, bound_by=bound_by,
                bound_fp32_ms=bound(nbytes, flops)[0],
                bound_tc_3xtf32_ms=bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0])


# BH=48 is the forward's [4, 1024] batch of 12 heads, BH=12 one document;
# the last two are ragged (nq != nk) both ways
SWEEP_ATTENTION = (tuple((48, n, n) for n in (37, 128, 256, 512, 1000, 1024, 2048))
                   + ((12, 1024, 1024), (48, 1024, 512), (48, 512, 1024)))


def sweep_gated_attention(mod, gen) -> None:
    """``--sweep``: ``gated_attention`` at each (BH, nq, nk) of
    SWEEP_ATTENTION, held against the plain version as in the kernels
    phase; one JSON line a shape."""
    for BH, nq, nk in SWEEP_ATTENTION:
        emit("sweep", kernel="gated_attention", **check_gated_attention(mod, gen, nq, nk, BH=BH))


def check_incr_patch(mod, gen, C: int, B=4, n=1024, H=12, dh=64, Q=64):
    """``incr_patch_batched`` against the plain version: within 1e-4
    (rtol 1e-5), fully masked rows and (for B > 1) an all-masked filler
    document exactly 0. The mask is ``check_fused_step``'s random one."""
    dev = torch.device("cuda")
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    args = (randn(B, n, H, dh), randn(B, H, C, dh), randn(B, H, C, dh),
            randn(B, H, C, Q), randn(B, H, C, Q),
            (torch.rand((B, n, C), generator=gen, device=dev) < 0.6).float())
    mask = args[5]
    mask[:, ::7] = 0.0  # fully masked rows (free slots)
    if B > 1:
        mask[B - 1] = 0.0  # a dispatch's filler document
    out = mod.incr_patch_batched(*args)
    want = mod.incr_patch_ref(*args)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    if not torch.allclose(out, want, atol=1e-4, rtol=1e-5):
        raise AssertionError(f"incr_patch {B}x{n}x{C}: differs by {err} "
                             "(atol 1e-4, rtol 1e-5)")
    dead = mask.sum(-1) == 0
    if not (out[dead] == 0).all():
        raise AssertionError(f"incr_patch {B}x{n}x{C}: fully masked rows are not 0")
    kernel = timings(lambda: mod.incr_patch_batched(*args), kernel="incr_patch")
    plain = timings(lambda: mod.incr_patch_ref(*args))
    live = float(mask.sum())
    nbytes = 4 * (sum(a.numel() for a in args) + out.numel())
    bound_ms, bound_by = bound(nbytes, live * H * (4 * dh + 4 * Q))
    return dict(B=B, n=n, C=C, max_abs_err=err, masked_rows=int(dead.sum()),
                ms=kernel["ms"], kernel_ms=kernel["kernel_ms"], call_ms=kernel["call_ms"],
                plain_ms=plain["ms"], plain_call_ms=plain["call_ms"],
                timing=kernel["timing"], bound_ms=bound_ms, bound_by=bound_by,
                live_mask_fraction=live / mask.numel())


# ------------------------------------------------------------------ serving


def make_stream(vocab: int, seed: int = 0, rounds: int = 5, per_doc: int = 6,
                lens=None):
    """Seeded rounds of (doc, Edit): ~60% replace / 20% insert / 20% delete
    per document per round. The 256-token document's first edit is an insert
    (it fills its capacity class: a grow), and round 2 adds 10 inserts at one
    position of the 1000-token document (gap exhaustion: a defrag).
    ``lens`` gives the documents' current lengths (default: as opened)."""
    from repro_torch.core.edits import Edit

    rng = np.random.default_rng(seed)
    lens = dict(lens or DOC_LENGTHS)
    stream = []
    for r in range(rounds):
        batch = []
        for did in DOC_LENGTHS:
            for i in range(per_doc):
                u = rng.random()
                if (r == 0 and i == 0 and did == "d256") or 0.6 <= u < 0.8:
                    e = Edit("insert", int(rng.integers(lens[did] + 1)), int(rng.integers(vocab)))
                elif u < 0.6:
                    e = Edit("replace", int(rng.integers(lens[did])), int(rng.integers(vocab)))
                else:
                    e = Edit("delete", int(rng.integers(lens[did])))
                lens[did] += {"replace": 0, "insert": 1, "delete": -1}[e.op]
                batch.append((did, e))
        if r == 2:
            at = int(rng.integers(1, lens["d1000"]))
            for _ in range(10):
                batch.append(("d1000", Edit("insert", at, int(rng.integers(vocab)))))
                lens["d1000"] += 1
        stream.append(batch)
    return stream


def serve(params, cfg, docs, stream, **kw):
    """Open the documents, send the stream round by round; returns the
    server and the per-flush latency stats (host clock, ends in a sync)."""
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.latency import LatencyStats

    srv = BatchServer(params, cfg, device=DEVICE, **kw)
    srv.open_documents({k: list(v) for k, v in docs.items()})
    torch.cuda.synchronize()
    lat = LatencyStats()
    for batch in stream:
        for did, e in batch:
            srv.submit_edit(did, e)
        t0 = time.perf_counter()
        srv.flush()
        torch.cuda.synchronize()
        lat.record((time.perf_counter() - t0) * 1e3)
    return srv, lat


def profiled(fn, names, top: int) -> dict:
    """``fn()`` once under torch.profiler: its wall time (ends in a sync),
    the device's busy time and idle share, the summed device time and
    launches of the kernels whose names hold each of ``names``, and the
    ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    by_name = {name: dict(ms=sum(e.self_device_time_total for e in mine) / 1e3,
                          count=sum(e.count for e in mine))
               for name in names for mine in [[e for e in dev if name in e.key]]}
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms, kernels=by_name,
                top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                                  count=e.count) for e in ranked])


def profile_round(srv, batch, names=("fused_step", "incr_patch")) -> dict:
    """One more round of edits on a served fleet under torch.profiler:
    the device's busy time against the round's wall time, the kernels
    that take it, by device time, and the summed device time and launches
    of each kernel whose name holds one of ``names``."""
    steps0 = srv.stats.batch_steps

    def round_():
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()

    prof = profiled(round_, names, top=10)
    edit_kernels = prof.pop("kernels")
    return dict(edits=len(batch), edit_dispatches=srv.stats.batch_steps - steps0,
                wall_ms_profiled=prof["wall_ms_profiled"],
                device_busy_ms=prof["device_busy_ms"],
                device_idle_share=prof["device_idle_share"], edit_kernels=edit_kernels,
                top_kernels=prof["top_kernels"])


def code_diff(srv_a, srv_b, did: str, vq_bias) -> int:
    """0 when the two servers' codes for ``did`` are equal. Otherwise the
    earliest layer with a difference must differ only at near-ties (the
    two paths' top-two scores within 1e-5; later layers inherit the
    flip) — returns that layer's flip count — else raises."""
    sa, sb = srv_a.state(did), srv_b.state(did)
    diff = (sa.codes != sb.codes) & sa.valid[None, :, None]
    if not bool(diff.any()):
        return 0
    first = int(diff.flatten(1).any(-1).nonzero()[0])
    hq, Q = vq_bias.shape[1:]
    n = sa.tokens.shape[0]
    near = torch.zeros_like(diff[first])
    for st in (sa, sb):
        causal = ((st.positions[None, :] <= st.positions[:, None]) & st.valid[None, :])
        counts = causal.float().sum(-1).clamp(min=1.0)
        s = (st.T[first].reshape(n, hq, -1, Q).sum(2) / counts[:, None, None]
             + vq_bias[first])
        top2 = s.topk(2, dim=-1).values
        near |= (top2[..., 0] - top2[..., 1]) <= 1e-5
    if bool((diff[first] & ~near).any()):
        raise AssertionError(f"{did}: codes differ at layer {first} away from near-ties")
    return int(diff[first].sum())


def n_layers(cfg) -> int:
    return len(cfg.layer_list())


def launch_counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from repro_torch.kernels import fused_step, gated_attention, incr_patch, vq_assign

    mods = (fused_step, gated_attention, incr_patch, vq_assign)
    return mods, lambda: {k: v for m in mods for k, v in m.LAUNCHES.items()}


def reset_launches() -> None:
    for m in launch_counters()[0]:
        m.reset_launches()


@contextlib.contextmanager
def fused_step_census():
    """Count the (B, n, C) shapes of the engine's ``fused_step`` calls while
    the block runs. The engine imports the wrapper by name, so the name is
    wrapped in ``jit_engine``; the wrapper itself is untouched. Yields a
    dict that fills with {"BxnxC": calls}."""
    from repro_torch.serving import jit_engine

    census: dict[str, int] = {}
    call = jit_engine.fused_patch_assign_batched

    def counted(q, k_new, *args, **kw):
        key = f"{q.shape[0]}x{q.shape[1]}x{k_new.shape[2]}"
        census[key] = census.get(key, 0) + 1
        return call(q, k_new, *args, **kw)

    with mock.patch.object(jit_engine, "fused_patch_assign_batched", counted):
        yield census


@contextlib.contextmanager
def delta_gate_census():
    """Count the row counts r of the engine's ``delta_gate`` calls while the
    block runs (the name is wrapped in ``jit_engine``, as in
    ``fused_step_census``). Yields a dict that fills with {r: calls}."""
    from repro_torch.serving import jit_engine

    census: dict[int, int] = {}
    call = jit_engine.delta_gate

    def counted(x_new, *args, **kw):
        census[x_new.shape[0]] = census.get(x_new.shape[0], 0) + 1
        return call(x_new, *args, **kw)

    with mock.patch.object(jit_engine, "delta_gate", counted):
        yield census


def sass_md5(build_dir: Path) -> dict | None:
    """{library: {kernel function: md5 of its SASS}} of the built libraries
    (``cuobjdump -sass``), so two builds of a shared source can show that a
    kernel's machine code did not change; None without cuobjdump. The
    anonymous namespace's per-file tag is cut from the names."""
    import hashlib
    import re

    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")  # the toolkit's own
    if not tool.exists():
        return None
    out = {}
    for lib in sorted(build_dir.glob("lib*.so")):
        text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        funcs, name = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+(?=\d)", "",
                              line.split("Function :")[1].strip())
                funcs[name] = hashlib.md5()
            elif name and line.strip().startswith("/*"):
                funcs[name].update(line.strip().encode())
        out[lib.stem.removeprefix("lib")] = {k: h.hexdigest() for k, h in funcs.items()}
    return out


def padded_batch(docs: dict, pool: int, width: int):
    """The documents as one [len(docs), width] batch: tokens in order, their
    allocator's sampled (gapped) position ids, padding after the last real
    row (token 0 at the pool's last id; causal order keeps it unseen)."""
    from repro_torch.core.positional import PositionAllocator

    toks = np.zeros((len(docs), width), np.int64)
    pos = np.full((len(docs), width), pool - 1, np.int64)
    for b, t in enumerate(docs.values()):
        toks[b, :len(t)] = t
        pos[b, :len(t)] = PositionAllocator(len(t), pool).snapshot()
    return toks, pos


def forward_phase(tparams, cfg, docs: dict, eng, width: int = 1024) -> dict:
    """``transformer.forward`` on the padded batch. Each document's last-row
    logits must match the engine's full forward within 1e-3, unless a VQ
    code flipped at a near-tie (the engine's top-two scores within 1e-4:
    the two routes sum the same products in another order)."""
    from repro_torch.core import vq as vq_mod
    from repro_torch.models import transformer as T

    toks, pos = padded_batch(docs, cfg.pos_pool, width)
    tt = torch.tensor(toks, device=DEVICE)
    tp = torch.tensor(pos, device=DEVICE)
    codes = []  # the forward's VQ codes, layer by layer
    quantize = vq_mod.quantize

    def recording(params, x):
        x_q, idx = quantize(params, x)
        codes.append(idx)
        return x_q, idx

    reset_launches()
    vq_mod.quantize = recording
    try:
        logits, _ = T.forward(tparams, cfg, tt, tp)
        torch.cuda.synchronize()
    finally:
        vq_mod.quantize = quantize
    launches = launch_counters()[1]()
    for name in ("gated_attention", "vq_assign"):
        if launches[name] != n_layers(cfg):
            raise AssertionError(f"forward: {name} launched {launches[name]} times "
                                 f"(expected {n_layers(cfg)} per call)")
    if not torch.isfinite(logits).all():
        raise AssertionError("forward: logits are not finite")
    diffs, flips = {}, {}
    m = eng.meta
    for b, (did, t) in enumerate(docs.items()):
        n = len(t)
        st = eng.full_forward(tt[b, :n], tp[b, :n])
        d = float((eng.logits_at(st, n - 1) - logits[b, n - 1]).abs().max())
        diff = torch.stack([c[b, :n] for c in codes]) != st.codes  # [L, n, hq]
        flips[did] = int(diff.sum())
        if flips[did]:
            first = int(diff.flatten(1).any(-1).nonzero()[0])
            causal = (st.positions[None, :] <= st.positions[:, None]).float()
            sc = (st.T[first].reshape(n, m["hq"], -1, m["Q"]).sum(2)
                  / causal.sum(-1)[:, None, None] + eng.W["vq_bias"][first])
            top2 = sc.topk(2, dim=-1).values
            if (diff[first] & ((top2[..., 0] - top2[..., 1]) > 1e-4)).any():
                raise AssertionError(f"forward: {did} codes differ at layer {first} "
                                     "away from near-ties")
        elif d > 1e-3:
            raise AssertionError(f"forward: {did} last-row logits differ by {d} (1e-3)")
        diffs[did] = d
    call = lambda: T.forward(tparams, cfg, tt, tp)
    ms = time_ms(call, warmup=2, iters=10)
    # one call under torch.profiler, retried (up to 3) when the trace drops
    # kernel records
    for _ in range(3):
        prof = profiled(call, ("gated_attention",), top=5)
        if prof["kernels"]["gated_attention"]["count"] == n_layers(cfg):
            break
    return dict(batch=list(tt.shape), launches={k: launches[k] for k in
                                                ("gated_attention", "vq_assign")},
                max_logits_diff=diffs, code_flips=flips, ms_per_forward=ms,
                tokens_per_s=tt.numel() / (ms / 1e3),
                profile=dict(device_busy_ms=prof["device_busy_ms"],
                             wall_ms_profiled=prof["wall_ms_profiled"],
                             gated_attention=prof["kernels"]["gated_attention"],
                             top_kernels=prof["top_kernels"]))


def first_token_near_tie(tparams, cfg, doc, cont: np.ndarray, j: int) -> float:
    """The gap between the top-two logits the oracle decoded token ``j``
    from: the document followed by its first ``j`` continuation tokens,
    through ``transformer.forward``."""
    from repro_torch.models import transformer as T

    seq_t = np.concatenate([doc.seq_tokens(), cont[:j]])
    last = int(doc.seq_positions()[-1])
    seq_p = np.concatenate([doc.seq_positions(), last + 1 + np.arange(j)])
    logits, _ = T.forward(tparams, cfg, torch.tensor(seq_t[None], device=DEVICE),
                          torch.tensor(seq_p[None], device=DEVICE))
    top2 = logits[0, -1].topk(2).values
    return float(top2[0] - top2[1])


def suggest_phase(params, cfg, docs: dict, stream, n_new: int = 8, appends: int = 6) -> dict:
    """Suggestion subscriptions on every document through the stream, plus
    ``appends`` tokens appended to the last (longest) document in round 0,
    which runs its continuation out of position ids (a defrag + retry).
    Every suggestion after every flush is held against the oracle."""
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.suggest import SuggestionEngine, oracle_suggestion
    from repro_torch.core.edits import Edit

    torch.cuda.reset_peak_memory_stats()
    srv = BatchServer(params, cfg, device=DEVICE)
    srv.open_documents({k: list(v) for k, v in docs.items()})
    for did in docs:
        srv.submit_suggest(did, n_new)
    oracle = SuggestionEngine(srv.suggester.params, cfg)
    tail = list(docs)[-1]
    rng = np.random.default_rng(1)
    rounds = [[]] + [list(b) for b in stream]
    n_tail = len(docs[tail]) + sum({"insert": 1, "delete": -1}.get(e.op, 0)
                                   for d, e in stream[0] if d == tail)
    rounds[1] += [(tail, Edit("insert", n_tail + i, int(rng.integers(cfg.vocab))))
                  for i in range(appends)]
    # a last round, profiled: one replace of each document's last token
    rounds.append(None)
    vq_launches, near_ties, checked, prof = 0, 0, 0, None
    for r, batch in enumerate(rounds):
        if batch is None:
            with fused_step_census() as census:
                prof = profile_round(srv, [(did, Edit("replace", srv.docs[did].n - 1,
                                                      int(rng.integers(cfg.vocab))))
                                           for did in docs])
            prof["fused_step_shapes"] = census
        else:
            for did, e in batch:
                srv.submit_edit(did, e)
            reset_launches()
            srv.flush()
            torch.cuda.synchronize()
            vq_launches += launch_counters()[1]()["vq_assign"]
        eng = srv.engine(srv.C, srv.R)
        for did in docs:
            got = srv.suggestion(did)
            doc = srv.docs[did]
            want = oracle_suggestion(srv.suggester.params, cfg, eng, doc.tokens,
                                     doc.positions, doc.valid, n_new, suggester=oracle)
            checked += 1
            if got is None or len(got) != n_new:
                raise AssertionError(f"suggest: {did} has no fresh suggestion")
            if not np.array_equal(got, want):
                j = int(np.flatnonzero(got != want)[0])
                gap = first_token_near_tie(srv.suggester.params, cfg, doc, want, j)
                if gap > 1e-4:
                    raise AssertionError(f"suggest: {did} token {j} differs from the "
                                         f"oracle (top-two logit gap {gap})")
                near_ties += 1
    if vq_launches < 1:
        raise AssertionError("suggest: vq_assign never launched inside the flushes")
    st, ss = srv.stats, srv.suggest_stats
    if st.suggest_headroom_defrags < 1:
        raise AssertionError("suggest: the appends did not force a headroom defrag")
    return dict(suggestions_checked=checked, near_tie_suggestions=near_ties,
                vq_assign_launches=vq_launches,
                headroom_defrags=st.suggest_headroom_defrags,
                refreshes=st.suggest_refreshes, refresh_ms_median=st.refresh_latency.p50,
                refresh_ms_max=st.refresh_latency.max_ms,
                prefill_rows_reused=ss.prefill_rows_reused,
                prefill_rows_recomputed=ss.prefill_rows_recomputed,
                rebuilds=ss.rebuilds, decode_steps=ss.decode_steps,
                bytes_suggest=st.bytes_suggest, defrags=st.defrags, grows=st.grows,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, profile=prof)


def patch_phase(params, cfg, docs, stream, fused) -> dict:
    """The stream through the unfused step with the ``incr_patch`` kernel,
    held against the fused server ``fused`` at the same point of the
    stream."""
    reset_launches()
    patch, _ = serve(params, cfg, docs, stream, use_fused_kernel=False,
                     use_patch_kernel=True)
    launches = launch_counters()[1]()
    st = patch.stats
    if launches["incr_patch"] != n_layers(cfg) * st.batch_steps:
        raise AssertionError(f"patch: incr_patch launched {launches['incr_patch']} times "
                             f"for {st.batch_steps} edit dispatches")
    if launches["fused_step"]:
        raise AssertionError("patch: the fused kernel ran on the unfused path")
    for name in ("grows", "defrags", "overflows", "batch_steps", "edits_applied"):
        if getattr(st, name) != getattr(fused.stats, name):
            raise AssertionError(f"patch: {name} differ (patch {getattr(st, name)}, "
                                 f"fused {getattr(fused.stats, name)})")
    vq_bias = fused.engine(fused.C, fused.R).W["vq_bias"]
    flips, logit_diff = {}, {}
    for did in docs:
        if not np.array_equal(patch.tokens(did), fused.tokens(did)):
            raise AssertionError(f"patch: {did} tokens differ")
        flips[did] = code_diff(fused, patch, did, vq_bias)
        if flips[did] == 0:
            logit_diff[did] = float(np.abs(patch.logits(did) - fused.logits(did)).max())
            if logit_diff[did] > 1e-3:
                raise AssertionError(f"patch: {did} logits differ by {logit_diff[did]}")
    dispatches = st.batch_steps
    # one more round under torch.profiler: the edits the profile phase
    # sends the fused server, so the two rounds' kernel times compare
    prof = profile_round(patch, make_stream(
        cfg.vocab, seed=1, rounds=1, lens={d: patch.docs[d].n for d in docs})[0])
    return dict(launches={"incr_patch": launches["incr_patch"]},
                edit_dispatches=dispatches, near_tie_flips=flips,
                max_logits_diff=logit_diff, profile=prof)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def tiered_budgets(cfg) -> tuple[int, int]:
    """(device, host) budget bytes of the tiered and async phases: the
    device budget holds two 1024-capacity states of ``cfg`` and half of a
    third (room for one suggestion decode cache, which is soft state), the
    host budget one state and half of a second."""
    from repro_torch.serving.jit_engine import state_nbytes_for_config

    per = state_nbytes_for_config(cfg, 1024)
    return int(2.5 * per), int(1.5 * per)


def reconcile(srv) -> dict:
    """Recount every byte and document counter of ``srv``'s state store from
    the objects themselves and raise unless ``BatchStats`` holds the same.
    Returns the recount."""
    from repro_torch.serving.jit_engine import state_nbytes

    s, tiers = srv.stats, srv.store.tiers()
    if set(tiers) != set(srv.docs):
        raise AssertionError("reconcile: the store and the server hold other documents")
    by = {t: [d for d, x in tiers.items() if x == t] for t in ("hot", "warm", "cold")}
    got = dict(docs_hot=len(by["hot"]), docs_warm=len(by["warm"]), docs_cold=len(by["cold"]),
               bytes_hot=sum(state_nbytes(srv.docs[d].state) for d in by["hot"]),
               bytes_warm=sum(srv.store.nbytes(d) for d in by["warm"]),
               bytes_cold=sum(srv.store.nbytes(d) for d in by["cold"]),
               bytes_suggest=sum(srv._sugg.cache_nbytes(k) for k in srv._sugg.cached_keys())
               if srv._sugg is not None else 0)
    for name, want in got.items():
        if getattr(s, name) != want:
            raise AssertionError(f"reconcile: {name} is {getattr(s, name)}, a recount {want}")
    if any(srv.docs[d].state is not None for d in by["warm"] + by["cold"]):
        raise AssertionError("reconcile: an evicted document still holds device state")
    if s.state_touches != s.hot_hits + s.rehydrations + s.rollback_rebuilds:
        raise AssertionError("reconcile: touches != hot hits + rehydrations + rebuilds")
    return got


def _serve_suggesting(srv, docs, stream, n_new: int):
    """Open ``docs`` on ``srv`` with ``n_new``-token subscriptions, send the
    stream round by round; returns each round's suggestions {doc: tokens}."""
    srv.open_documents({k: list(v) for k, v in docs.items()})
    for did in docs:
        srv.submit_suggest(did, n_new)
    rounds = []
    for batch in [[]] + list(stream):
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()
        rounds.append({did: srv.suggestion(did) for did in docs})
    return rounds


def tiered_phase(params, cfg, docs: dict, stream, n_new: int = 8) -> dict:
    """The serve stream with ``n_new``-token suggestions on every document
    through a server whose device budget holds two 1024-capacity states and
    whose host budget holds one (``tiered_budgets``), against an unbudgeted
    server with the same dispatches (both max_batch 2: a dispatch needs its
    chunk hot at once). Tokens, suggestions, state leaves and logits must be
    bitwise equal; then one document is checkpointed, exported and
    imported into a second server with bitwise logits."""
    import tempfile

    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.jit_engine import state_nbytes_for_config, state_to_host

    budget, host_budget = tiered_budgets(cfg)
    per = state_nbytes_for_config(cfg, 1024)
    # the unbudgeted server first, kept on the host, so the budgeted one's
    # peak memory is its own
    free = BatchServer(params, cfg, max_batch=2, device=DEVICE)
    want_sugg = _serve_suggesting(free, docs, stream, n_new)
    want = {did: (free.tokens(did), free.logits(did), state_to_host(free.state(did)))
            for did in docs}
    want_dispatches = free.stats.batch_steps
    del free
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    spill = tempfile.mkdtemp(prefix="chip-smoke-cold-")
    srv = BatchServer(params, cfg, max_batch=2, device_budget_bytes=budget,
                      host_budget_bytes=host_budget, spill_dir=spill, device=DEVICE)
    dropped = []
    drop = srv.store._drop_suggest

    def counted_drop(doc_id):
        if srv._sugg is not None and srv._sugg.cache_nbytes(doc_id):
            dropped.append(doc_id)
        drop(doc_id)

    srv.store._drop_suggest = counted_drop
    reset_launches()
    got_sugg = _serve_suggesting(srv, docs, stream, n_new)
    launches = launch_counters()[1]()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    weights = tensor_bytes(srv._weights[:2]) + tensor_bytes(srv.suggester.params)
    st = srv.stats
    for name in ("evictions", "spills", "rehydrations"):
        if getattr(st, name) < 1:
            raise AssertionError(f"tiered: the budgets forced no {name}")
    if not dropped:
        raise AssertionError("tiered: no suggestion cache was dropped")
    if st.batch_steps != want_dispatches:
        raise AssertionError(f"tiered: {st.batch_steps} dispatches, unbudgeted {want_dispatches}")
    if launches["fused_step"] != n_layers(cfg) * st.batch_steps:
        raise AssertionError(f"tiered: fused_step launched {launches['fused_step']} times for "
                             f"{st.batch_steps} edit dispatches")
    for r, (g, w) in enumerate(zip(got_sugg, want_sugg)):
        for did in docs:
            if g[did] is None or not np.array_equal(g[did], w[did]):
                raise AssertionError(f"tiered: {did} suggestion after round {r} differs "
                                     f"({g[did]} vs {w[did]})")
    recount = reconcile(srv)
    for did in docs:
        toks, logits, state = want[did]
        if not np.array_equal(srv.tokens(did), toks):
            raise AssertionError(f"tiered: {did} tokens differ")
        if not np.array_equal(srv.logits(did), logits):
            raise AssertionError(f"tiered: {did} logits differ from the unbudgeted server's")
        for name, a, b in zip(state._fields, state_to_host(srv.state(did)), state):
            if not np.array_equal(a, b):
                raise AssertionError(f"tiered: {did} state leaf {name} differs")
    reconcile(srv)
    tiers = srv.store.tiers()
    # one forced eviction of a hot document: the device memory must fall by
    # at least its state's bytes (its decode cache goes too)
    victim = next(d for d in docs if tiers[d] == "hot")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    srv.evict(victim, "warm")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if before - after < srv.store.nbytes(victim):
        raise AssertionError(f"tiered: evicting {victim} freed {before - after} bytes of its "
                             f"{srv.store.nbytes(victim)}")
    reconcile(srv)
    # migration: checkpoint, export, import into a second server
    moved = "d300"
    ref_logits = srv.logits(moved)
    path = f"{spill}/{moved}.migrate.npz"
    srv.checkpoint_document(moved, path)
    srv.export_document(moved, path)
    other = BatchServer(params, cfg, max_batch=2, device=DEVICE)
    other.import_document(moved, path)
    if not np.array_equal(other.logits(moved), ref_logits):
        raise AssertionError("tiered: the imported document's logits differ")
    reconcile(srv)
    out = dict(budget_bytes=budget, host_budget_bytes=host_budget, state_bytes_1024=per,
               evictions=st.evictions, spills=st.spills, rehydrations=st.rehydrations,
               suggest_caches_dropped=len(dropped), hot_hit_rate=st.hot_hit_rate,
               state_touches=st.state_touches, edit_dispatches=st.batch_steps,
               fused_step_launches=launches["fused_step"], tiers=tiers, recount=recount,
               peak_mem_bytes=peak, weights_bytes=weights, evicted=victim,
               evict_mem_before=before, evict_mem_after=after,
               evict_state_bytes=srv.store.nbytes(victim), migrated=moved,
               exports=st.exports, imports=other.stats.imports)
    for did in list(srv.docs):
        srv.close_document(did)
    if os.listdir(spill):
        raise AssertionError(f"tiered: closing every document left {os.listdir(spill)}")
    os.rmdir(spill)
    return out


def async_phase(params, cfg, docs: dict, stream, n_new: int = 8) -> dict:
    """One client thread per document through ``AsyncBatchServer``
    (``max_batch_delay_ms=8``) over a budgeted server: each client subscribes
    to its document's suggestions, then per round of the stream submits its
    share and waits for a fresh suggestion. Final tokens and every
    suggestion must equal a sequential ``BatchServer`` fed each document's
    requests in the same order; streamed token events must reassemble into
    each streamed continuation."""
    import tempfile
    import threading

    from repro_torch.serving.async_server import AsyncBatchServer
    from repro_torch.serving.batch_server import BatchServer

    budget, host_budget = tiered_budgets(cfg)
    spill = tempfile.mkdtemp(prefix="chip-smoke-cold-")
    srv = BatchServer(params, cfg, max_batch=2, device_budget_bytes=budget,
                      host_budget_bytes=host_budget, spill_dir=spill, device=DEVICE)
    got = {did: [] for did in docs}
    errors = []

    def client(asrv, did, sub):
        try:
            for batch in stream:
                for d, e in batch:
                    if d == did:
                        asrv.submit_edit(did, e)
                got[did].append(asrv.suggest(did, n_new).result(600))
        except BaseException as exc:  # reported on the main thread
            errors.append((did, exc))

    t0 = time.perf_counter()
    with AsyncBatchServer(srv, max_batch_delay_ms=8.0) as asrv:
        for t in [asrv.open_document(d, list(v)) for d, v in docs.items()]:
            t.result(600)
        subs = {did: asrv.subscribe(did, n_new) for did in docs}
        threads = [threading.Thread(target=client, args=(asrv, did, subs[did])) for did in docs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        final = {did: asrv.tokens(did).result(600) for did in docs}
        astats = asrv.stats
    wall_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"async: client {errors[0][0]} failed: {errors[0][1]!r}")
    streamed = {}
    for did, sub in subs.items():
        toks, n = {}, 0
        while True:
            kind, serial, *rest = sub.get(timeout=5.0)
            if kind == "closed":
                break
            if kind == "token":
                toks.setdefault(serial, []).append(rest[1])
            elif toks.get(serial) != list(rest[0]):
                raise AssertionError(f"async: {did} streamed tokens differ from refresh {serial}")
            else:
                n += 1
        streamed[did] = n
    # the sequential replay
    seq = BatchServer(params, cfg, device=DEVICE)
    for did, toks in docs.items():
        seq.open_document(did, list(toks))
        for r, batch in enumerate(stream):
            for d, e in batch:
                if d == did:
                    seq.submit_edit(did, e)
            want = seq.suggest(did, n_new)
            if not np.array_equal(got[did][r], want):
                raise AssertionError(f"async: {did} suggestion after round {r} differs "
                                     f"from the sequential replay ({got[did][r]} vs {want})")
        if not np.array_equal(final[did], seq.tokens(did)):
            raise AssertionError(f"async: {did} tokens differ from the sequential replay")
    if astats.requests_failed:
        raise AssertionError(f"async: {astats.requests_failed} requests failed")
    if min(streamed.values()) < 1:
        raise AssertionError("async: a subscription streamed no suggestion")
    st = srv.stats
    lat = {name: dict(count=h.count, p50_ms=h.p50, p99_ms=h.p99, max_ms=h.max_ms)
           for name, h in (("edit_latency", st.edit_latency),
                           ("suggest_latency", st.suggest_latency))}
    for did in list(srv.docs):
        srv.close_document(did)
    os.rmdir(spill)
    return dict(wall_s=wall_s, rounds=astats.rounds, deadline_rounds=astats.deadline_rounds,
                full_rounds=astats.full_rounds, edits=astats.admitted_edits,
                edits_per_round=astats.mean_edits_per_round,
                suggests=astats.admitted_suggests, streamed_suggestions=streamed,
                evictions=st.evictions, spills=st.spills, rehydrations=st.rehydrations,
                hot_hit_rate=st.hot_hit_rate, edit_dispatches=st.batch_steps, **lat)


def fleet_phase(params, cfg, docs: dict, stream, n_new: int = 8) -> dict:
    """``FleetRouter`` with 2 replica workers on the card (the full config,
    seed 0) and the four documents. The 256-token document runs alone
    through its round-0 edits (a grow), migrates to the other replica, then
    takes 16 inserts at one position (a defrag); after each stretch its
    logits are bitwise equal to an in-process server fed the same edits one
    at a time, and its suggestions token-exact. Then the other documents'
    round-0 edits, a checkpoint, a hard kill of one replica with edits in
    flight: every document resumes token-exact on the survivor. The fleet
    closes leaving no child process and no cold file."""
    import tempfile

    from repro_torch.core.edits import Edit, apply_edit
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.fleet import FleetRouter, RemoteOpError, ReplicaDiedError

    from repro_torch.configs import get_config

    smoke = cfg != get_config("vq-opt-125m")  # the workers build ``cfg`` too
    if get_config("vq-opt-125m", smoke=smoke) != cfg:
        raise ValueError("fleet: the workers build vq-opt-125m or its smoke config only")
    wait = 600.0
    mig = "d256"
    refs = {d: list(v) for d, v in docs.items()}
    oracle = BatchServer(params, cfg, device=DEVICE)
    oracle.open_document(mig, refs[mig])
    cold = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    t0 = time.perf_counter()
    fleet = FleetRouter(2, smoke=smoke, seed=0, cold_dir=cold, device=DEVICE,
                        max_batch_delay_ms=5.0)
    boot_s = time.perf_counter() - t0
    out = dict(boot_s=boot_s, worker_boot_s=[r.boot_s for r in fleet.replicas])
    try:
        fleet.open_document(mig, refs[mig]).result(wait)
        for t in [fleet.open_document(d, refs[d]) for d in docs if d != mig]:
            t.result(wait)
        out["placement"] = {d: fleet.owner_of(d) for d in docs}

        def edit_alone(e):
            fleet.submit_edit(mig, e).result(wait)
            oracle.submit_edit(mig, e)
            oracle.flush()
            refs[mig] = apply_edit(refs[mig], e)

        def same_as_oracle(when: str) -> None:
            if not np.array_equal(fleet.logits(mig).result(wait), oracle.logits(mig)):
                raise AssertionError(f"fleet: {mig} logits differ from the oracle {when}")
            got, want = fleet.suggest(mig, n_new).result(wait), oracle.suggest(mig, n_new)
            if not np.array_equal(got, want):
                raise AssertionError(f"fleet: {mig} suggestion differs {when} ({got} vs {want})")

        for d, e in stream[0]:
            if d == mig:
                edit_alone(e)
        if oracle.stats.grows < 1:
            raise AssertionError("fleet: the edits before the move forced no grow")
        same_as_oracle("before the move")
        src = fleet.owner_of(mig)
        t1 = time.perf_counter()
        fleet.migrate(mig, 1 - src)
        out["migrate_ms"] = (time.perf_counter() - t1) * 1e3
        same_as_oracle("right after the move")
        rng = np.random.default_rng(5)
        at = len(refs[mig]) // 2
        defrags = oracle.stats.defrags
        for _ in range(16):
            edit_alone(Edit("insert", at, int(rng.integers(cfg.vocab))))
        if oracle.stats.defrags <= defrags:
            raise AssertionError("fleet: the inserts after the move forced no defrag")
        same_as_oracle("after the move's defrag")
        # the other documents' round-0 share, all in flight together
        tickets = []
        for d, e in stream[0]:
            if d != mig:
                tickets.append(fleet.submit_edit(d, e))
                refs[d] = apply_edit(refs[d], e)
        for t in tickets:
            t.result(wait)
        for d in docs:
            if list(fleet.tokens(d).result(wait)) != refs[d]:
                raise AssertionError(f"fleet: {d} tokens differ from the host replay")
        agg = fleet.stats(wait)
        per = agg["per_replica"]
        for name in ("edits_applied", "hot_hits", "state_touches", "exports", "imports",
                     "docs", "closes"):
            if agg[name] != sum(s["batch"][name] for s in per):
                raise AssertionError(f"fleet: the router's {name} is not the replicas' sum")
        n_acked = oracle.stats.edits_applied + len(tickets)
        if agg["edits_applied"] != n_acked or agg["exports"] != 1 or agg["imports"] != 1:
            raise AssertionError(f"fleet: {agg['edits_applied']} edits applied for {n_acked} "
                                 f"acked, {agg['exports']} exports, {agg['imports']} imports")
        out["stats"] = {k: agg[k] for k in (
            "edits_applied", "docs_open", "rounds", "deadline_rounds", "full_rounds",
            "hot_hit_rate", "exports", "imports", "edit_latency", "suggest_latency")}
        out["stats"]["router"] = agg["router"]
        out["stats"]["grows"] = [s["batch"]["grows"] for s in per]
        out["stats"]["defrags"] = [s["batch"]["defrags"] for s in per]
        # failover: a checkpoint, edits in flight, a hard kill
        fleet.checkpoint(wait)
        victim = fleet.owner_of(mig)
        lost = [d for d in docs if fleet.owner_of(d) == victim]
        inflight = []
        for i, d in enumerate(lost):
            pos, tok = i, int(rng.integers(cfg.vocab))
            inflight.append((d, pos, tok, fleet.submit_replace(d, pos, tok)))
        t1 = time.perf_counter()
        fleet.kill_replica(victim)
        out["failover_ms"] = (time.perf_counter() - t1) * 1e3
        replayed = 0
        for d, pos, tok, t in inflight:
            try:
                t.result(wait)
            except (ReplicaDiedError, RemoteOpError):
                fleet.submit_replace(d, pos, tok).result(wait)
                replayed += 1
            refs[d][pos] = tok
        for d in docs:
            if fleet.owner_of(d) != 1 - victim:
                raise AssertionError(f"fleet: {d} is not on the survivor")
            tok = int(rng.integers(cfg.vocab))
            fleet.submit_insert(d, 2, tok).result(wait)
            refs[d].insert(2, tok)
            if list(fleet.tokens(d).result(wait)) != refs[d]:
                raise AssertionError(f"fleet: {d} tokens differ after the failover")
        out.update(failed_over=lost, replayed=replayed, router=dataclasses.asdict(fleet.stats_fleet))
    finally:
        fleet.close_fleet()
    alive = [r.proc.pid for r in fleet.replicas if r.proc.poll() is None]
    if alive or os.listdir(cold):
        raise AssertionError(f"fleet: close left processes {alive} and files {os.listdir(cold)}")
    os.rmdir(cold)
    return out


SWEEPS = ("delta_gate", "vq_assign", "patch", "gated_attention")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", nargs="?", const=",".join(SWEEPS), metavar="NAMES",
                   help="after the build, only time delta_gate over r with each "
                        "launch shape forced, vq_assign over token counts with each "
                        "schedule forced, fused_step and incr_patch over (B, n, C) "
                        "and gated_attention over (BH, nq, nk); a comma list of "
                        f"{SWEEPS} picks some (no other phase, no ok line)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.vq_opt_125m import config
    from repro_torch.core.edits import apply_edits
    from repro_torch.kernels import _build
    from repro_torch.kernels import gated_attention as gak
    from repro_torch.kernels import incr_patch as ipk
    from repro_torch.kernels import vq_assign as vqk
    from repro_torch.kernels.fused_step import ops, ref
    from repro_torch.models.transformer import init_params, params_from_numpy

    # ---- 1. device
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", seconds=time.perf_counter() - t0, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # ---- 2. build
    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = [l.strip() for p in sorted(_build.build_dir().glob("*.ptxas.txt"))
             for l in p.read_text().splitlines() if "registers" in l or "spill" in l]
    emit("build", seconds=time.perf_counter() - t0, compiled=compiled,
         out_dir=str(_build.build_dir().relative_to(ROOT)), ptxas=ptxas,
         sass_md5=sass_md5(_build.build_dir()))
    if args.sweep:
        sweeps = dict(delta_gate=lambda g: sweep_delta_gate(ops, ref, g),
                      vq_assign=lambda g: sweep_vq_assign(vqk, g),
                      patch=lambda g: sweep_patch(ops, ref, ipk, g),
                      gated_attention=lambda g: sweep_gated_attention(gak, g))
        for name in args.sweep.split(","):
            sweeps[name](torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0

    # ---- 3. kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused = [check_fused_step(ops, ref, gen, C) for C in (8, 72, 264)]
    fused.append(check_fused_step(ops, ref, gen, 72, causal=True))
    gates = [check_delta_gate(ops, ref, gen, r, timed=True) for r in SWEEP_GATE[:-1]]
    floor = launch_floor()
    vqs = [check_vq_assign(vqk, gen, B, N) for B, N in ((4, 1024), (1, 1024), (1, 32), (1, 1))]
    gas = [check_gated_attention(gak, gen, n) for n in (1024, 1000, 37)]
    ips = [check_incr_patch(ipk, gen, C) for C in (8, 72, 264)]
    ips.append(check_incr_patch(ipk, gen, 1032, B=1))  # the most served step
    emit("kernels", seconds=time.perf_counter() - t0, fused_step=fused,
         delta_gate=gates, launch_floor=floor, vq_assign=vqs, gated_attention=gas,
         incr_patch=ips)

    # ---- 4. serve (the main path)
    cfg = config()
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    docs = {did: [int(t) for t in rng.integers(0, cfg.vocab, n)]
            for did, n in DOC_LENGTHS.items()}
    stream = make_stream(cfg.vocab)
    reset_launches()
    with fused_step_census() as serve_shapes:
        srv, lat = serve(params, cfg, docs, stream)
    serve_launches = dict(ops.LAUNCHES)
    if sum(serve_shapes.values()) != serve_launches["fused_step"]:
        raise AssertionError(f"serve: the shape census counted {sum(serve_shapes.values())} "
                             f"fused_step calls, the wrapper {serve_launches['fused_step']}")
    st = srv.stats
    for did, toks in docs.items():
        replay = apply_edits(toks, [e for batch in stream for d, e in batch if d == did])
        if not np.array_equal(srv.tokens(did), replay):
            raise AssertionError(f"serve: {did} tokens differ from the host replay")
        if not np.isfinite(srv.logits(did)).all():
            raise AssertionError(f"serve: {did} logits are not finite")
    for name in ("grows", "defrags", "overflows"):
        if getattr(st, name) < 1:
            raise AssertionError(f"serve: the stream forced no {name[:-1]}")
    if serve_launches["fused_step"] != n_layers(cfg) * st.batch_steps:
        raise AssertionError(
            f"serve: fused_step launched {serve_launches['fused_step']} times for "
            f"{st.batch_steps} edit dispatches (expected {n_layers(cfg)} per dispatch)")
    total_s = lat.total_ms / 1e3
    emit("serve", seconds=time.perf_counter() - t0, nvidia_smi=smi, init_params_s=init_s, edits=st.edits_applied,
         edit_dispatches=st.batch_steps, launches=serve_launches,
         fused_step_shapes=serve_shapes,
         grows=st.grows, defrags=st.defrags, overflows=st.overflows,
         full_forwards=st.full_forwards, traced_shapes=st.traced_shapes,
         mean_batch=st.mean_batch, edits_per_s=st.edits_applied / total_s,
         flush_ms_median=lat.p50, flush_ms=lat.samples,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # ---- 5. parity: the inline path
    t0 = time.perf_counter()
    inline, _ = serve(params, cfg, docs, stream,
                      use_fused_kernel=False)
    for name in ("grows", "defrags", "overflows"):
        if getattr(inline.stats, name) != getattr(st, name):
            raise AssertionError(f"parity: {name} differ (inline "
                                 f"{getattr(inline.stats, name)}, fused {getattr(st, name)})")
    vq_bias = srv.engine(srv.C, srv.R).W["vq_bias"]
    flips, logit_diff = {}, {}
    for did in docs:
        if not np.array_equal(srv.tokens(did), inline.tokens(did)):
            raise AssertionError(f"parity: {did} tokens differ")
        flips[did] = code_diff(srv, inline, did, vq_bias)
        if flips[did] == 0:
            logit_diff[did] = float(np.abs(srv.logits(did) - inline.logits(did)).max())
            if logit_diff[did] > 1e-3:
                raise AssertionError(f"parity: {did} logits differ by {logit_diff[did]}")
    emit("parity", seconds=time.perf_counter() - t0, near_tie_flips=flips,
         max_logits_diff=logit_diff)
    del inline

    # ---- 6. threshold
    t0 = time.perf_counter()
    reset_launches()
    with delta_gate_census() as gate_rows:
        thr, _ = serve(params, cfg, docs, stream,
                       delta_threshold=1.0)
    thr_launches = dict(ops.LAUNCHES)
    for did in docs:
        if not np.array_equal(thr.tokens(did), srv.tokens(did)):
            raise AssertionError(f"threshold: {did} tokens differ")
    if thr_launches["delta_gate"] < 1:
        raise AssertionError("threshold: delta_gate never launched")
    if sum(gate_rows.values()) != thr_launches["delta_gate"]:
        raise AssertionError(f"threshold: the census counted {sum(gate_rows.values())} "
                             f"delta_gate calls, the wrapper {thr_launches['delta_gate']}")
    if thr_launches["fused_step"] != n_layers(cfg) * thr.stats.batch_steps:
        raise AssertionError("threshold: fused_step launches != 12 per dispatch")
    dispatches, overflows = thr.stats.batch_steps, thr.stats.overflows
    # one more round under torch.profiler: the profile phase's edits
    with delta_gate_census() as round_rows:
        thr_prof = profile_round(thr, make_stream(
            cfg.vocab, seed=1, rounds=1, lens={d: thr.docs[d].n for d in docs})[0],
            names=("delta_gate", "fused_step"))
    gate_prof = thr_prof["edit_kernels"]["delta_gate"]
    thr_prof.update(gate_rows=round_rows,
                    delta_gate_busy_share=gate_prof["ms"] / thr_prof["device_busy_ms"])
    emit("threshold", seconds=time.perf_counter() - t0, nvidia_smi=smi,
         launches=thr_launches, gate_rows=gate_rows, edit_dispatches=dispatches,
         overflows=overflows, profile=thr_prof)
    del thr

    # ---- 7. patch: the unfused step with the incr_patch kernel
    t0 = time.perf_counter()
    pat = patch_phase(params, cfg, docs, stream, srv)
    emit("patch", seconds=time.perf_counter() - t0, **pat)

    # ---- 8. where the time goes: one more profiled round on the served fleet
    t0 = time.perf_counter()
    with fused_step_census() as census:
        prof = profile_round(srv, make_stream(
            cfg.vocab, seed=1, rounds=1, lens={d: srv.docs[d].n for d in docs})[0])
    prof["fused_step_shapes"] = census
    emit("profile", seconds=time.perf_counter() - t0, nvidia_smi=smi, **prof)

    # ---- 9. forward: the model's own entry point
    t0 = time.perf_counter()
    fwd = forward_phase(params_from_numpy(params, device=DEVICE), cfg, docs,
                        srv.engine(srv.C, srv.R))
    emit("forward", seconds=time.perf_counter() - t0, nvidia_smi=smi, **fwd)

    # ---- 10. suggest: suggestion subscriptions through the stream
    t0 = time.perf_counter()
    sug = suggest_phase(params, cfg, docs, stream)
    emit("suggest", seconds=time.perf_counter() - t0, nvidia_smi=smi, **sug)

    # ---- 11. tiered: the state store under device and host budgets
    t0 = time.perf_counter()
    tier = tiered_phase(params, cfg, docs, stream[:3])
    emit("tiered", seconds=time.perf_counter() - t0, nvidia_smi=smi, **tier)

    # ---- 12. async: concurrent clients through the deadline batcher
    t0 = time.perf_counter()
    asy = async_phase(params, cfg, docs, stream[:2])
    emit("async", seconds=time.perf_counter() - t0, nvidia_smi=smi, **asy)

    # ---- 13. fleet: two replica workers on the card, migration, failover
    t0 = time.perf_counter()
    flt = fleet_phase(params, cfg, docs, stream)
    emit("fleet", seconds=time.perf_counter() - t0, nvidia_smi=smi, **flt)

    # ---- summary
    c72 = next(f for f in fused if f["C"] == 72 and f["mask"] == "random")
    r_top = max(gate_rows, key=gate_rows.get)  # the most served r
    gate_top = (next((g for g in gates if g["r"] == r_top), None)
                or check_delta_gate(ops, ref, gen, r_top, timed=True))
    kernels = [
        dict(name="fused_step", route="cuda", source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step/fused_step.py:179",
             launches=serve_launches["fused_step"],
             max_abs_err=max(f["max_abs_err"] for f in fused), ms=c72["ms"],
             plain_ms=c72["plain_ms"], bound_ms=c72["bound_ms"],
             bound_by=c72["bound_by"], library_ms=None),
        dict(name="delta_gate", route="cuda", source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step/fused_step.py:242",
             launches=thr_launches["delta_gate"],
             max_abs_err=max(g["max_abs_err"] for g in gates + [gate_top]),
             ms=gate_top["ms"], plain_ms=gate_top["plain_ms"],
             bound_ms=gate_top["bound_ms"], bound_by=gate_top["bound_by"],
             library_ms=None, r=r_top, launch_floor_ms=floor["ms"]),
    ]
    vq1024 = next(v for v in vqs if v["B"] == 1 and v["N"] == 1024)  # a prefill chunk
    ga1024 = next(g for g in gas if g["nq"] == 1024)
    ip72 = next(i for i in ips if i["B"] == 4 and i["C"] == 72)
    for name, src, tpu, launches, errs, row in (
            ("vq_assign", "vq_assign.cu", "vq_assign/vq_assign.py:61",
             sug["vq_assign_launches"], vqs, vq1024),
            ("gated_attention", "gated_attention.cu",
             "gated_attention/gated_attention.py:90",
             fwd["launches"]["gated_attention"], gas, ga1024),
            ("incr_patch", "incr_patch.cu", "incr_patch/incr_patch.py:119",
             pat["launches"]["incr_patch"], ips, ip72)):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=f"src/repro/kernels/{tpu}", launches=launches,
            max_abs_err=max(e["max_abs_err"] for e in errs), ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    next(k for k in kernels if k["name"] == "gated_attention").update(
        cores=GA_CORES, bound_fp32_ms=ga1024["bound_fp32_ms"],
        bound_tc_3xtf32_ms=ga1024["bound_tc_3xtf32_ms"])
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
