#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. device     — the card's name and power limit (nvidia-smi), CUDA version;
                TF32 off for matmuls and cuDNN (TF32 flips VQ codes).
2. build      — nvcc builds ``src/repro_torch/csrc/*.cu`` for sm_90a into
                ``build/repro_torch_kernels/``.
3. kernels    — ``fused_step`` at the main path's shapes (B=4, n=1024, H=12,
                dh=Q=64, hq=2, C in {8, 72, 264}) and ``delta_gate`` (d=768)
                against their plain versions on the card, then timed with
                CUDA events (median of 25 after warm-up) and
                with torch.profiler (device time per call).
4. serve      — full-width VQ-OPT-125M (random weights from seed 0) behind
                ``BatchServer(device="cuda")``: 4 documents (256, 300, 700
                and 1000 tokens) and a seeded mixed edit stream that forces
                a grow, a defrag and an overflow fallback; tokens must equal
                a host replay, logits must be finite, and ``fused_step`` must
                launch 12 times per edit dispatch.
5. parity     — the same stream through ``use_fused_kernel=False``: equal
                tokens, counters and codes, logits within 1e-3 (a code may
                differ only at a near-tie, top-two scores within 1e-5).
6. threshold  — the same stream at ``delta_threshold=1.0``: exact tokens,
                and ``delta_gate`` launched.
7. profile    — one more round of edits on the served fleet under
                torch.profiler: device busy time against wall time, and the
                kernels that take it.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
the last line ``{"ok": true, "device": {...}}``. The launch counts in the
kernels line come from the path that runs each kernel (serve for
``fused_step``, threshold for ``delta_gate``), with the counters set to 0
just before that path; launches made to compare or time a kernel do not
count. Exits non-zero without a GPU and outside a checkout of the repo.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
N_LAYERS = 12
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


def device_ms(fn, iters: int = 25):
    """Mean device milliseconds per call: the CUDA kernels (and copies)
    torch.profiler traced over ``iters`` calls, without the host's launch
    gaps. None when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us > 0 else None


def timings(fn) -> dict:
    """``ms``: device time per call from the profiler trace, or the event
    time when the trace holds none; ``call_ms``: CUDA-event time around one
    call, which includes the host's wrapper work when that is the longer."""
    call = time_ms(fn)
    dev = device_ms(fn)
    return dict(ms=dev if dev is not None else call, call_ms=call,
                timing="profiler" if dev is not None else "events")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ kernels


def check_fused_step(ops, ref, gen, C: int, B=4, n=1024, H=12, dh=64, Q=64, hq=2):
    dev = torch.device("cuda")
    g = H // hq
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    q, k_new, k_old = randn(B, n, H, dh), randn(B, H, C, dh), randn(B, H, C, dh)
    vc_new, vc_old = randn(B, H, C, Q), randn(B, H, C, Q)
    mask = (torch.rand((B, n, C), generator=gen, device=dev) < 0.6).float()
    mask[:, ::7] = 0.0  # fully masked rows (dirty rows, free slots)
    mask[B - 1] = 0.0  # a dispatch's filler document
    T_base = randn(B, n, H, Q)
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
    if not torch.equal(T_k[dead], T_base[dead]):
        raise AssertionError(f"fused_step C={C}: fully masked rows changed T_base")
    kernel = timings(lambda: ops.fused_patch_assign_batched(*args, heads_per_vq=g))
    plain = timings(lambda: ref.fused_patch_assign_ref(*args))
    live = float(mask.sum())
    nbytes = 4 * (sum(a.numel() for a in args) + T_k.numel() + codes_k.numel())
    flops = live * H * (4 * dh + 4 * Q) + 2 * B * n * H * Q + 2 * B * n * hq * Q
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(C=C, max_abs_err=err, near_tie_rows=int(near.sum()),
                near_tie_flips=int(flips.sum()), masked_rows=int(dead.sum()),
                ms=kernel["ms"], call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                bound_ms=bound_ms, bound_by=bound_by,
                live_mask_fraction=live / mask.numel())


def check_delta_gate(ops, ref, gen, r: int, d: int = 768, threshold: float = 1.0,
                     timed: bool = False):
    dev = torch.device("cuda")
    x_old = torch.randn((r, d), generator=gen, device=dev)
    x_new = x_old + (torch.rand((r, d), generator=gen, device=dev) * 2 - 1) * 1.2
    x_old[:4] = 2.5  # largest change EXACTLY the threshold: strict > drops it
    x_new[:4] = 2.5
    x_new[:4, 0] = 2.5 + threshold
    x_new[4] = x_old[4]  # an unchanged row
    keep = ops.delta_gate(x_new, x_old, threshold)
    plain = ref.delta_gate_ref(x_new, x_old, threshold)
    torch.cuda.synchronize()
    if not torch.equal(keep, plain) or keep[:5].any():
        raise AssertionError(f"delta_gate r={r}: keep bits differ from the plain version")
    out = dict(r=r, d=d, kept=int(keep.sum()), max_abs_err=0.0)
    if timed:
        kernel = timings(lambda: ops.delta_gate(x_new, x_old, threshold))
        plain = timings(lambda: ref.delta_gate_ref(x_new, x_old, threshold))
        out.update(ms=kernel["ms"], call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                   plain_call_ms=plain["call_ms"], timing=kernel["timing"])
        out["bound_ms"], out["bound_by"] = bound(4 * 2 * r * d + r, 3 * r * d)
    return out


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


def profile_round(srv, batch) -> dict:
    """One more round of edits on a served fleet under torch.profiler:
    the device's busy time against the round's wall time, and the kernels
    that take it, by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps0 = srv.stats.batch_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for did, e in batch:
            srv.submit_edit(did, e)
        srv.flush()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    return dict(edits=len(batch), edit_dispatches=srv.stats.batch_steps - steps0,
                wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_kernels=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                                  count=e.count) for e in top])


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


def main() -> int:
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
    from repro_torch.kernels.fused_step import ops, ref
    from repro_torch.models.transformer import init_params

    # ---- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # ---- 2. build
    t0 = time.perf_counter()
    compiled = _build.build_all()
    ptxas = [l.strip() for p in sorted(_build.build_dir().glob("*.ptxas.txt"))
             for l in p.read_text().splitlines() if "registers" in l or "spill" in l]
    emit("build", seconds=time.perf_counter() - t0, compiled=compiled,
         out_dir=str(_build.build_dir().relative_to(ROOT)), ptxas=ptxas)

    # ---- 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused = [check_fused_step(ops, ref, gen, C) for C in (8, 72, 264)]
    gates = [check_delta_gate(ops, ref, gen, r) for r in (64, 1024)]
    gate_timed = check_delta_gate(ops, ref, gen, 4 * 64, timed=True)  # B=4 x R=64
    emit("kernels", fused_step=fused, delta_gate=gates + [gate_timed])

    # ---- 4. serve (the main path)
    cfg = config()
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    docs = {did: [int(t) for t in rng.integers(0, cfg.vocab, n)]
            for did, n in DOC_LENGTHS.items()}
    stream = make_stream(cfg.vocab)
    ops.reset_launches()
    srv, lat = serve(params, cfg, docs, stream)
    serve_launches = dict(ops.LAUNCHES)
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
    if serve_launches["fused_step"] != N_LAYERS * st.batch_steps:
        raise AssertionError(
            f"serve: fused_step launched {serve_launches['fused_step']} times for "
            f"{st.batch_steps} edit dispatches (expected {N_LAYERS} per dispatch)")
    total_s = lat.total_ms / 1e3
    emit("serve", nvidia_smi=smi, init_params_s=init_s, edits=st.edits_applied,
         edit_dispatches=st.batch_steps, launches=serve_launches,
         grows=st.grows, defrags=st.defrags, overflows=st.overflows,
         full_forwards=st.full_forwards, traced_shapes=st.traced_shapes,
         mean_batch=st.mean_batch, edits_per_s=st.edits_applied / total_s,
         flush_ms_median=lat.p50, flush_ms=lat.samples,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # ---- 5. parity: the inline path
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
    emit("parity", near_tie_flips=flips, max_logits_diff=logit_diff)
    del inline

    # ---- 6. threshold
    ops.reset_launches()
    thr, _ = serve(params, cfg, docs, stream,
                   delta_threshold=1.0)
    thr_launches = dict(ops.LAUNCHES)
    for did in docs:
        if not np.array_equal(thr.tokens(did), srv.tokens(did)):
            raise AssertionError(f"threshold: {did} tokens differ")
    if thr_launches["delta_gate"] < 1:
        raise AssertionError("threshold: delta_gate never launched")
    if thr_launches["fused_step"] != N_LAYERS * thr.stats.batch_steps:
        raise AssertionError("threshold: fused_step launches != 12 per dispatch")
    emit("threshold", launches=thr_launches, edit_dispatches=thr.stats.batch_steps,
         overflows=thr.stats.overflows)

    # ---- 7. where the time goes: one more profiled round on the served fleet
    emit("profile", nvidia_smi=smi, **profile_round(srv, make_stream(
        cfg.vocab, seed=1, rounds=1, lens={d: srv.docs[d].n for d in docs})[0]))

    # ---- summary
    c72 = next(f for f in fused if f["C"] == 72)
    kernels = [
        dict(name="fused_step", route="cuda", source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step/fused_step.py:179",
             launches=serve_launches["fused_step"],
             max_abs_err=max(f["max_abs_err"] for f in fused), ms=c72["ms"],
             plain_ms=c72["plain_ms"], bound_ms=c72["bound_ms"],
             bound_by=c72["bound_by"], library_ms=None),
        dict(name="delta_gate", route="cuda", source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step/fused_step.py:242",
             launches=thr_launches["delta_gate"], max_abs_err=0.0,
             ms=gate_timed["ms"], plain_ms=gate_timed["plain_ms"],
             bound_ms=gate_timed["bound_ms"], bound_by=gate_timed["bound_by"],
             library_ms=None),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
