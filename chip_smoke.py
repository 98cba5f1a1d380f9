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
                call's; the single-document ``fused_patch_assign`` at
                n=1024, C=264 bitwise a B=1 batched launch, both counted),
                ``delta_gate`` (d=768, r from 64 to 2048: the
                served row counts; keep bits equal) beside the launch floor
                (a one-element ``zero_()``), ``vq_assign`` (hq=2,
                Q=64, dv=384; B=4 x N=1024, N=1024, N=32 and N=1, and
                the families' (N, dv) of ``FAMILY_VQ``, hymba's dv=800
                and deepseek's dv=8192 among them: idx equal away from
                near-ties, x_q bitwise the codebook row; the VQ kernel's own
                device time by name beside the wrapper's),
                ``gated_attention`` (BH=48, dh=64, n in {1024, 1000, 37},
                and the train step's BH=96 at n=1024;
                dh=128 at phi4-mini's BH=24, n=4096, dh=256 at gemma3's
                BH=16, n=3072 and dh=64 at hymba's BH=25, n=4096, each
                also at n=1000; within 1e-5; its
                bound at its route's peak, 3xTF32 on the tensor cores,
                beside the FP32 cores'), the ``gated_attention`` backward
                (``BWD_ATTENTION``: BH=96 and 48 at n=1024, BH=48 at n in
                {1000, 37, 1}, dh=64; ``BWD_FAMILIES``: phase 20's
                dh=128 at BH=24 and dh=256 at BH=16, n in {4096, 1000},
                and hymba's BH=25, n=4096, dh=64; dq, dk and dv each
                within 1e-5 of the plain version's max |.|; the dK/dV and
                dQ kernels' device ms apart; its bound, 5 products a causal
                pair, at the 3xTF32 route's peak, on which it runs, beside
                the FP32 cores')
                and ``incr_patch`` (B=4, n=1024, H=12, C in
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
                tokens, counters and codes, logits within 3e-4 (a code may
                differ only at a near-tie, top-two scores within 1e-5).
6. threshold  — the same stream at ``delta_threshold=1.0``: exact tokens,
                ``delta_gate`` launched, a census of the row counts r it
                ran at; then the profile phase's round of edits under
                torch.profiler (``delta_gate``'s device time, launches and
                share of the busy time).
7. patch      — the serve stream through ``use_fused_kernel=False,
                use_patch_kernel=True``: tokens and counters equal the
                fused server's, codes equal except at near-ties, logits
                within 3e-4, 12 ``incr_patch`` launches per edit dispatch;
                then the profile phase's round of edits under torch.profiler
                (``incr_patch`` device time and launches).
8. profile    — one more round of edits on the served fleet under
                torch.profiler: device busy time against wall time, and the
                kernels that take it; then each (B, n_cap, C, R) the round
                dispatched priced by ``launch/roofline.py``'s
                ``edit_step_roofline`` at its H100 peaks and the engine's
                weight bytes, the analytic floor summed over the round
                beside the busy time (``xla_flops``: ``FlopCounterMode``'s
                count of one dispatch, which does not see the hand-written
                kernels' products; numbers only, no gate).
9. forward    — ``models.transformer.forward`` on the 4 documents padded to
                a [4, 1024] batch with their sampled position ids: each
                document's last-row logits within 3e-4 of the engine's
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
13. fleet     — ``FleetRouter`` with 2 replica workers on the card, or one
                a card on a machine with two or more (full
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
14. incremental — the paper's measurement path: the 4 documents opened in
                the op-counting ``IncrementalServer`` on the card and the
                serve stream applied as atomic edits in its order; each
                edit's counted ops beside the dense from-scratch cost and
                its host-clock ms (synchronized). Prints the totals, the
                cumulative speedup, the per-edit ratio's median, min and
                max, defrags and ms per edit (median, max). Then each
                final state against the engine's own ``full_forward``
                (codes equal but for near ties, top-two scores within
                1e-4, which are counted; logits within 3e-4 and the last
                layer's states within 5e-5 where no code flipped), the serve
                phase's ``BatchServer`` slot codes and ``logits()``
                against the same engine's full forward of its tokens and
                positions, and the 256-token document's edits replayed in
                step on a CPU twin: equal op counts, or a near tie at the
                first diverging code (reported).
15. mesh      — the serve stream with an 8-token subscription on the
                256-token document through ``BatchServer(mesh=...,
                max_batch=8)``: k = 2 blocks on the one card, or one block
                a card on 2 or 4 cards. Against a single-device server on
                the same stream: tokens equal (and the host replay),
                ``edits_applied`` equal, slot codes equal but for counted
                near ties (top-two within 1e-4), logits within 3e-4 where
                none flipped, the suggestion equals the oracle's,
                ``sharded_dispatches`` > 0, 12 × k ``fused_step`` launches
                an edit dispatch, one weight replica per distinct device.
                Then a one-entry mesh is bitwise the ``device="cuda"``
                server (every state leaf, ``logits()``, the suggestion).
                Prints the census of block shapes (B/k, n, C), the mean
                shard imbalance, state moves between devices, edits/s for
                both servers (host clock; host-bound, no claim), and peak
                memory per device beside the weight replicas' bytes.
16. families  — the dense-attention families (``phi4_phase``,
                ``gemma3_phase``, ``smoke_families``). phi4-mini-3.8B with
                VQT at full width and depth (4.46 B parameters drawn on the
                card from seed 0): a [1, 4096] forward (32 ``gated_attention``
                launches at BH=24, n=4096, dh=128 and 32 ``vq_assign``;
                finite logits), timed (tokens/s) and profiled; prefill of
                4,080 tokens in 1,024-token chunks and 16 decode steps
                within 2e-3 of the forward's last 16 rows (a row whose own
                VQ code flipped at a near tie, top-two scores within 1e-4,
                is exempt and counted); the softmax model on the same
                weights streams every layer, and layer 0's streaming
                attention is within 2e-5 of the dense core. gemma3-12b
                with VQT at full width, depth cut to one 5-local : 1-global
                pattern (6 layers): a [1, 3072] forward (5 streamed σ
                layers, 1 ``gated_attention`` launch at dh=256), then 1,100
                decode steps past the 1,024-slot ring, the last within
                2e-3 of a [1, 1100] forward. stablelm, h2o-danube (80
                tokens, past its smoke window), internvl2 (8 patch
                embeddings) and musicgen (4 codebooks) at smoke size, both
                variants: launches by route, decode against forward.
                Each model's weights are freed before the next.
17. recurrent — the recurrent families (``rwkv6_phase``, ``hymba_phase``,
                ``hymba_ring_phase``), weights drawn on the card from seed
                0. rwkv6-7b at full width and depth (7.5 B parameters): a
                [1, 4096] forward (no kernel of the port's; finite
                logits), timed and profiled; layer 0's time-mix operands
                through the chunked and the sequential scan within 1e-4,
                the chunked scan timed; 64 decode steps from an empty
                state, the last within 2e-3 of a [1, 64] forward (each
                step's difference printed), one more step profiled.
                hymba-1.5b with VQT at full width and depth: a [1, 4096]
                forward (3 ``gated_attention`` launches at
                BH=25, n=4096, dh=64, 29 streamed windowed layers, 32
                ``vq_assign`` at dv=800; finite logits), timed and
                profiled; layer 0's SSM scan as rwkv6's; 64 decode steps
                within 2e-3 of a [1, 64] forward (near-tie code flips
                exempt and counted); the softmax model on the same
                weights streams every layer. hymba at full width, depth
                cut to one global and one local layer: 1,100 decode steps
                past the 1,024-slot ring, the last within 2e-3 of a
                [1, 1100] forward.
18. moe       — the MLA / MoE families (``deepseek_v2_phase``,
                ``deepseek_v3_phase``), weights drawn on the card from seed
                0. deepseek-v2-236b with VQT at full width (d 5120, 128
                heads, MLA kv_lora 512, 160 experts top-6 + 2 shared),
                depth cut 60 -> 3 (the dense layer, 2 MoE layers; 9.3 B
                parameters): a [1, 4096] forward (MLA streamed, 3
                ``vq_assign`` launches at N=4096, dv=8192, no
                ``gated_attention``; finite logits and aux loss), timed
                and profiled; layer 0's MLA through the streaming and the
                dense path within 2e-5; MoE layer 1 on 256 tokens, the
                routed dispatch against the reference's loop form (every
                expert on every token) within 2e-5, and ``moe_per_code``
                on 64 rows indexed by [4, 1024] against the dense MoE,
                each pair timed; 64 decode steps, the last within 2e-3 of
                a [1, 64] forward (a token whose VQ code or routing flipped
                at a near tie, router k-th and (k+1)-th probabilities
                within 1e-5, exempt and counted), one more step profiled.
                deepseek-v3-671b with VQT and its MTP head at full width,
                cut 61 -> 2 (one dense, one MoE layer of 256 experts): a
                [1, 1024] forward (finite ``logits`` and ``mtp_logits``,
                2 ``vq_assign``), 16 decode steps checked the same way.
19. train     — training (``train_phase``). One train step of VQ-OPT at
                full width, depth cut to 2 layers, on [2, 256] on the card
                against the same step on the CPU through the plain
                versions (``card_vs_cpu_step``: the same weights, batch and
                Gumbel noise; VQ codes equal but where the top two Gumbel
                logits lie within 1e-5, counted; a draw in which one flipped
                is drawn again, up to 3 draws; then the loss within 1e-5
                and every gradient leaf within 1e-4 of its max). VQ-OPT-125M at full width and depth (281 M
                parameters, seed 0) through ``make_train_step`` with remat:
                8 steps at [8, 1024] of ``SyntheticCorpus(seed=0)`` with
                sampled positions, lr 6e-4, warmup 1; every loss finite,
                the last below the first, 24 ``gated_attention`` launches
                and 12 of each backward kernel a step; ms a step and
                tokens/s over steps 2-8, peak memory, one more step
                profiled. 3 ``make_distill_step`` steps with a full-width
                OPT-125M teacher (kl, lm finite). ``save_pytree`` ->
                ``restore_pytree`` of the trained weights (bitwise), and a
                ``BatchServer`` serving a 256-token document from them
                gives logits bitwise equal to one serving the weights in
                memory.
20. family_train — every family's training (``family_train_phase``).
                ``card_vs_cpu_step`` (b=2) on the smoke configs with VQT of
                deepseek-v2 and -v3 (MLA, MoE, v3's MTP loss; routes may
                differ only at a near tie, k-th and (k+1)-th router
                probabilities within 1e-5, and a draw with one is drawn
                again), hymba, rwkv6 (no VQ), phi4-mini with its heads
                widened to 128 and gemma3 to 256 (past its 64-token
                window, n=96), so the wide backward kernels run: the loss
                within 1e-5 and every gradient leaf within 1e-4 of its
                max. Then five models at full width, weights drawn on the
                card from seed 0 (``FAMILY_TRAIN``): hymba-1.5b VQT (cut
                32 -> 8: its 3 global layers, 5 windowed), phi4-mini-3.8B
                VQT (cut 32 -> 12), gemma3-12b VQT
                (cut 48 -> 6, one global layer at dh=256), rwkv6-7b (cut
                32 -> 4), deepseek-v2-236b VQT (cut 60 -> 1, its dense MLA
                layer), each through ``make_train_step`` with remat for 3
                steps at [1, 4096] (``train_4k``'s length, from the port's
                ``launch/specs.py``) of ``SyntheticCorpus(seed=0)``, lr 6e-4,
                warmup 1: every loss and grad norm finite, every small
                parameter leaf moved, 2 ``gated_attention`` launches and
                one of each backward kernel a step a σ layer without a
                window; the loss over the steps, ms a step and tokens/s
                over steps 2-3, peak memory, the launches by shape, one
                more step profiled (device busy and idle, the top
                kernels). Each model is freed before the next.
21. grid      — the model axis and the expert-parallel MoE
                (``grid_phase``). (a) deepseek-v2-236b's MoE layer at full
                width (router, 160 experts top-6 at d 5120, f 1536, and 2
                shared experts: 15.3 GB drawn on the card from seed 0) on
                [1, 1024] seeded normal tokens: ``moe_apply_ep`` on (data,
                model) grids (1, 1) and (1, 4) whose entries are the one
                card, against ``moe_apply_dense``: with the capacity factor
                raised to 160 / 6 no assignment may drop and EP must lie
                within 2e-5 of dense (a token routed differently at a near
                tie, k-th and (k+1)-th probabilities within 1e-5, exempt
                and counted); at the config's 1.25 the dropped assignments
                a slice are printed and tokens without one must lie within
                2e-5. ms a call (CUDA events) for EP at M = 1 and 4 and for
                dense, the bytes the exchanges copied, one profiled call
                each (device idle share). With two or more cards, the
                experts placed once on a (1, k) grid of k cards (k of 8, 5,
                4, 2 dividing 160): within 2e-5 of the one-card (1, k)
                grid (bitwise or not printed), the peak memory each card
                holds. (b) one train step of deepseek-v2's smoke config
                with VQT under a (2, 2) grid of the card against the same
                under a (2, 2) grid of the CPU (``card_vs_cpu_step``), and
                the same at (1, 1); ``launch.train``'s ``--mesh host``
                step function on the card goes through ``moe_apply_ep``
                and gives the loss of ``make_train_step`` under a (1, 1)
                grid, bitwise.
22. sharded_train — the train step run by the sharding plan
                (``sharded_phase``): VQ-OPT-125M under (2, 2) and (1, 4)
                grids of the card against 1x1, placed steps with every
                replica bitwise, phi4-mini (4 layers) under (1, 2); with
                more cards a (1, k) grid of them. ``--phase
                sharded_train`` runs it alone.
23. sharded_decode — the decode caches' and the recurrent mixers' plans
                (``sharded_decode_phase``), on grids whose entries repeat
                the card: (a) hymba-1.5b at full width and depth, VQT and
                plain, batch 1, caches of ``long_500k``'s 524,288 tokens
                drawn from a seeded generator (``fill_caches``), 4 greedy
                steps on a (4, 1) grid (the sequence over 4 rows) against
                1x1; (b) phi4-mini-3.8B VQT and rwkv6-7b at full width, 4
                layers, batch 8, 32,768-token caches, 8 steps on (2, 2);
                (c) rwkv6-7b and hymba-1.5b (2 global, 2 windowed layers)
                at full width, one train step at [1, 2048] on (1, 2)
                against 1x1 (``sharded_check``). Greedy tokens equal,
                logits within the 2e-3 decode gate, loss within 1e-5,
                gradient leaves within 1e-4 of their max, cache replicas
                bitwise; ms a step, bytes by kind, launches, peak memory.
                ``--phase sharded_decode`` runs it alone; with four cards
                it adds (a) with the sequence over the cards and rwkv6-7b
                trained at full width on a (1, 4) grid of them.

Then the card's name and power limit, one ``{"kernels": [...]}`` line
(``delta_gate`` at the threshold phase's most served r), and the last line
``{"ok": true, "device": {...}}``. The launch counts in the
kernels line come from the path that runs each kernel (serve for
``fused_step``, threshold for ``delta_gate``, forward for
``gated_attention``, the suggest flushes for ``vq_assign``, patch for
``incr_patch``; ``fused_step``'s ``mesh_launches`` from the mesh phase;
``gated_attention``'s ``head_dims`` and ``vq_assign``'s ``dv1536`` and
``dv2048`` from the families phase's forwards, ``gated_attention``'s
``hymba`` and ``vq_assign``'s ``dv800`` from the recurrent phase's hymba
forward, ``vq_assign``'s ``dv8192`` from the moe phase's deepseek-v2
forward, ``gated_attention_bwd`` (both backward kernels) from the train
phase's 8 full-size steps, and its ``head_dims`` (dh 64, 128 and 256 at
n=4096) from the family_train phase's steps),
with the counters set to 0 just before that path; launches made to compare
or time a kernel do not count. Exits non-zero without a GPU
and outside a checkout of the repo.

``--sweep`` runs phases 1 and 2, then times the launch floor and
``delta_gate`` at r in {64, ..., 4096} (d=768) under the wrapper's launch
shape and with each of ``ops.GATE_SHAPES`` (rows a CTA, burst or
stream) forced, ``vq_assign`` at 1 to 4,096 tokens (dv=384) and at the
families' (N, dv) under the wrapper's schedule rule and with each schedule
forced (the numbers behind the rule), and ``fused_step`` and
``incr_patch``, each against its plain version, at every (B, n, C) the serve phase's edit steps
run at (B in {1, 2, 4}, n=1024, C in {8, 72, 136, 264}; 1x1024x520 and
1x1024x1032) and at 1x4096x72, ``incr_patch`` also with each of its two
layouts forced, and ``gated_attention`` against its plain version at
BH=48 x n in {37, 128, 256, 512, 1000, 1024, 2048}, BH=12 x n=1024,
BH=48 at (nq, nk) = (1024, 512) and (512, 1024) (dh=64), and dh=128 at
BH=24 x n in {4096, 1000}, dh=256 at BH=16 x n in {3072, 1000} and dh=64
at hymba's BH=25 x n in {4096, 1000}, with both bounds, and the
``gated_attention`` backward at ``SWEEP_BWD`` (the train step's BH=96 x
n=1024, BH=48 x n in {128, 256, 512, 1000, 1024, 2048}, and
``BWD_FAMILIES``), each held to
``BWD_TOL``, the dK/dV and dQ kernels' device ms apart; one
line a shape, and prints no ok line. ``--sweep delta_gate,patch`` runs only
the named sweeps (of ``delta_gate``, ``vq_assign``, ``patch``,
``gated_attention``, ``gated_attention_bwd``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
    ``kernel_ms``: the device time of the kernels whose name holds it,
    ``kernels``: their names, and ``kernel_by_name``: each one's time."""
    call = time_ms(fn)
    by_name = device_ms(fn)
    out = dict(ms=sum(by_name.values()) if by_name else call, call_ms=call,
               timing="profiler" if by_name else "events")
    if kernel is not None:
        mine = {k.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void "): v
                for k, v in by_name.items() if kernel in k}
        out["kernel_ms"] = sum(mine.values()) or None
        out["kernels"] = sorted(mine)
        out["kernel_by_name"] = mine
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
    2e-5 (rtol 1e-5), codes equal away from near-ties, fully masked rows
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
    if not torch.allclose(T_k, T_p, atol=2e-5, rtol=1e-5):
        raise AssertionError(f"fused_step C={C}: T differs by {err} (atol 2e-5, rtol 1e-5)")
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


def check_fused_step_single(ops, gen, C: int = 264, n: int = 1024, H: int = 12,
                            dh: int = 64, Q: int = 64, hq: int = 2) -> dict:
    """The single-document ``fused_patch_assign`` against a B = 1 launch of
    ``fused_patch_assign_batched`` on the same inputs (on ``gen``'s
    device): T and codes bitwise equal, each call one counted launch."""
    dev = gen.device
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    mask = (torch.rand((n, C), generator=gen, device=dev) < 0.6).float()
    mask[::7] = 0.0
    counts = torch.randint(1, n + 1, (n,), generator=gen, device=dev).float()
    args = (randn(n, H, dh), randn(H, C, dh), randn(H, C, dh), randn(H, C, Q),
            randn(H, C, Q), mask, randn(n, H, Q), counts)
    vq_bias = randn(hq, Q)
    before = ops.LAUNCHES["fused_step"]
    T, codes = ops.fused_patch_assign(*args, vq_bias, heads_per_vq=H // hq)
    T_b, codes_b = ops.fused_patch_assign_batched(*(a[None] for a in args), vq_bias,
                                                  heads_per_vq=H // hq)
    launches = ops.LAUNCHES["fused_step"] - before
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not (torch.equal(T.view(torch.int32), T_b[0].view(torch.int32))
            and torch.equal(codes, codes_b[0])):
        raise AssertionError(f"fused_patch_assign C={C}: not bitwise the B=1 batched launch")
    if launches != 2:
        raise AssertionError(f"fused_patch_assign C={C}: {launches} counted launches, expected 2")
    return dict(n=n, C=C, bitwise=True, launches=launches)


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


# the (tokens, dv) of phases 16-18's vq_assign calls: phi4-mini's forward,
# prefill chunks and decode steps (dv 1536), gemma3's forward and decode
# steps (dv 2048), hymba's forward and decode steps (dv 800), deepseek-v2's
# forward, deepseek-v3's forward and both decode steps (dv 8192: 128 heads
# of v 128 over 2 VQ heads)
FAMILY_VQ = ((4096, 1536), (1024, 1536), (1, 1536), (3072, 2048), (1, 2048),
             (4096, 800), (1, 800), (4096, 8192), (1024, 8192), (1, 8192))


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
        raise AssertionError(f"vq_assign B={B} N={N} dv={dv}: {int((flips & ~near).sum())} "
                             "indices differ away from near-ties")
    heads = torch.arange(hq, device=dev)
    if not torch.equal(xq.reshape(B, N, hq, dv), cb[heads, idx.long()]):
        raise AssertionError(f"vq_assign B={B} N={N} dv={dv}: x_q is not bitwise C[idx]")
    xq = xq.reshape(B, N, hq, dv)
    if not torch.equal(xq[~flips], xq_p[~flips]):
        raise AssertionError(f"vq_assign B={B} N={N} dv={dv}: x_q differs from the plain version")
    err = float((xq - xq_p).abs().max())
    kernel = timings(call, kernel="vq_assign_")
    plain = timings(lambda: mod.vq_assign_ref(x.reshape(B, N, hq, dv), cb))
    nbytes = 4 * (2 * x.numel() + cb.numel() + B * N * hq)
    bound_ms, bound_by = bound(nbytes, 2 * B * N * hq * Q * dv)
    return dict(B=B, N=N, dv=dv, kernels=kernel["kernels"], max_abs_err=err,
                near_tie_rows=int(near.sum()), near_tie_flips=int(flips.sum()),
                ms=kernel["ms"], kernel_ms=kernel["kernel_ms"],
                call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                bound_ms=bound_ms, bound_by=bound_by)


SWEEP_TOKENS = (1, 32, 128, 256, 384, 512, 1024, 1536, 2048, 4096)
SWEEP_SCHEDULES = ("small", "large16", "large32")  # vq_assign/ops.py SCHEDULES


def sweep_vq_assign(mod, gen) -> None:
    """``--sweep``: ``vq_assign`` (hq=2, Q=64) at dv=384 for each of
    SWEEP_TOKENS tokens, then at each (tokens, dv) of FAMILY_VQ, under the
    wrapper's schedule rule and with each schedule forced, every call first
    held against the plain version as in the kernels phase; one JSON line a
    shape."""
    for n, dv in tuple((n, 384) for n in SWEEP_TOKENS) + FAMILY_VQ:
        row = dict(N=n, dv=dv, rule=check_vq_assign(mod, gen, 1, n, dv=dv))
        for name in SWEEP_SCHEDULES:
            with mock.patch.object(mod.ops, "schedule", lambda _t, _n=name: _n, create=True):
                row[name] = check_vq_assign(mod, gen, 1, n, dv=dv)
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
    bound of the kernel's route (``bound_ms``) and of the FP32 CUDA cores.
    dh is the head dim of q, k and v (64, 128 or 256)."""
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
    return dict(BH=BH, nq=nq, nk=nk, dh=dh, max_abs_err=err, ms=kernel["ms"],
                kernel_ms=kernel["kernel_ms"], kernels=kernel["kernels"],
                call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                cores=GA_CORES, bound_ms=bound_ms, bound_by=bound_by,
                bound_fp32_ms=bound(nbytes, flops)[0],
                bound_tc_3xtf32_ms=bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0])


# (BH, nq, nk, dh). BH=48 is the VQ-OPT forward's [4, 1024] batch of 12
# heads, BH=12 one document; then two ragged (nq != nk) both ways; then
# phi4-mini's forward (24 heads of 128) and gemma3's global layer (16 of
# 256), then hymba's global layers (25 heads of 64, GQA 25 : 5 repeated by
# the wrapper), each also at a ragged n = 1000
WIDE_ATTENTION = ((24, 4096, 4096, 128), (24, 1000, 1000, 128),
                  (16, 3072, 3072, 256), (16, 1000, 1000, 256))
HYMBA_ATTENTION = ((25, 4096, 4096, 64), (25, 1000, 1000, 64))
SWEEP_ATTENTION = (tuple((48, n, n, 64) for n in (37, 128, 256, 512, 1000, 1024, 2048))
                   + ((12, 1024, 1024, 64), (48, 1024, 512, 64), (48, 512, 1024, 64))
                   + WIDE_ATTENTION + HYMBA_ATTENTION)


def sweep_gated_attention(mod, gen) -> None:
    """``--sweep``: ``gated_attention`` at each (BH, nq, nk, dh) of
    SWEEP_ATTENTION, held against the plain version as in the kernels
    phase; one JSON line a shape."""
    for BH, nq, nk, dh in SWEEP_ATTENTION:
        emit("sweep", kernel="gated_attention",
             **check_gated_attention(mod, gen, nq, nk, BH=BH, dh=dh))


def attention_bwd_work(BH: int, n: int, dh: int = 64) -> tuple[int, int]:
    """The compulsory bytes (q, k, v and dO read once, dq, dk and dv
    written once) and FP32 operations of the ``gated_attention`` backward
    at nq = nk = n: the 5 products the gradient needs (S, dW, dV, dK, dQ),
    2 dh operations each a causal (query, key) pair; GELUs not counted.
    The kernels recompute S and dW in both of their passes: that work is
    the design's, not the function's, and stays out of the bound."""
    pairs = n * (n + 1) // 2
    return 7 * BH * n * dh * 4, BH * pairs * 5 * 2 * dh


# (BH, n) of the backward's checks: the VQ-OPT train step's [8, 1024] batch
# of 12 heads, then [4, 1024], a ragged n, a short one and a single row
BWD_ATTENTION = ((96, 1024), (48, 1024), (48, 1000), (48, 37), (48, 1))
# (BH, n, dh) of the families' train steps (phase 20): phi4-mini's 24 heads
# of 128 and gemma3's global layer's 16 of 256 (GQA repeated by the
# wrapper), each also at a ragged n = 1000, and hymba's 25 heads of 64
BWD_FAMILIES = ((24, 4096, 128), (24, 1000, 128), (16, 4096, 256), (16, 1000, 256),
                (25, 4096, 64))
BWD_TOL = 1e-5  # dq, dk, dv against the plain version, relative to its max |.|
# (BH, n, dh) of ``--sweep gated_attention_bwd``: the train step's, then
# BH=48 over n, a ragged n = 1000 among them (dh = 64), then the families'
SWEEP_BWD = (((96, 1024, 64),) + tuple((48, n, 64) for n in (128, 256, 512, 1000, 1024, 2048))
             + BWD_FAMILIES)


def check_gated_attention_bwd(mod, gen, n: int, BH: int = 48, dh: int = 64) -> dict:
    """``gated_attention_bwd_bh`` against ``gated_attention_bwd_ref`` on the
    card: each of dq, dk and dv within ``BWD_TOL`` of the plain version's
    max |.|; device ms of the two kernels together (``ms``) and apart
    (``dkv_ms``, ``dq_ms``), and the plain version's. The kernels run on
    the tensor cores in 3xTF32 as the forward (``cores``); ``bound_ms`` is
    the bound at that route's peak, beside the FP32 cores'
    (``bound_fp32_ms``)."""
    dev = torch.device("cuda")
    q, k = (torch.randn((BH, n, dh), generator=gen, device=dev) * 0.5 for _ in range(2))
    v, do = (torch.randn((BH, n, dh), generator=gen, device=dev) for _ in range(2))
    got = mod.gated_attention_bwd_bh(q, k, v, do)
    want = mod.gated_attention_bwd_ref(q, k, v, do)
    torch.cuda.synchronize()
    abs_err, rel_err = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        abs_err[name] = float((g - w).abs().max())
        rel_err[name] = abs_err[name] / max(float(w.abs().max()), 1e-30)
        if not rel_err[name] <= BWD_TOL:
            raise AssertionError(f"gated_attention_bwd {BH}x{n}: {name} differs by "
                                 f"{rel_err[name]} of its max (tolerance {BWD_TOL})")
    kernel = timings(lambda: mod.gated_attention_bwd_bh(q, k, v, do),
                     kernel="gated_attention_bwd")
    plain = timings(lambda: mod.gated_attention_bwd_ref(q, k, v, do))
    part = lambda tag: sum(  # noqa: E731
        ms for name, ms in kernel["kernel_by_name"].items() if tag in name) or None
    nbytes, flops = attention_bwd_work(BH, n, dh)
    bound_ms, bound_by = bound(nbytes, GA_PRODUCTS * flops, GA_PEAK)
    return dict(BH=BH, n=n, dh=dh, rel_err=rel_err, tolerance=BWD_TOL,
                max_abs_err=max(abs_err.values()), ms=kernel["ms"],
                kernel_ms=kernel["kernel_ms"], kernels=kernel["kernels"],
                dkv_ms=part("_dkv_"), dq_ms=part("_dq_"),
                call_ms=kernel["call_ms"], plain_ms=plain["ms"],
                plain_call_ms=plain["call_ms"], timing=kernel["timing"],
                cores=GA_CORES, bound_ms=bound_ms, bound_by=bound_by,
                bound_fp32_ms=bound(nbytes, flops)[0],
                bound_tc_3xtf32_ms=bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0])


def sweep_gated_attention_bwd(mod, gen) -> None:
    """``--sweep``: the ``gated_attention`` backward at each (BH, n) of
    SWEEP_BWD, held to ``BWD_TOL`` as in the kernels phase; one JSON line
    a shape."""
    for BH, n, dh in SWEEP_BWD:
        emit("sweep", kernel="gated_attention_bwd",
             **check_gated_attention_bwd(mod, gen, n, BH=BH, dh=dh))


def bwd_kernel_entry(gabs: list[dict], launches: int, head_dims: dict | None = None) -> dict:
    """The ``gated_attention_bwd`` entry of the kernels line, from the
    kernels phase's checks ``gabs`` (the train step's BH=96, n=1024 shape
    timed) and the train phase's backward ``launches``; with ``head_dims``
    ({dh: launches of phase 20's train steps}) also a row a family shape of
    ``BWD_FAMILIES`` at n = 4096 (``head_dims``: times, both bounds, the
    dK/dV and dQ kernels apart). It replaces no Pallas entry
    (``gradient_of`` says what the reference differentiates), so it carries
    no ``replaces``."""
    gab = next(g for g in gabs if g["BH"] == 96 and g["n"] == 1024)
    rows = [dict(dh=g["dh"], BH=g["BH"], n=g["n"], launches=(head_dims or {}).get(g["dh"], 0),
                 max_abs_err=g["max_abs_err"], max_rel_err=max(g["rel_err"].values()),
                 ms=g["ms"], dkv_ms=g["dkv_ms"], dq_ms=g["dq_ms"], plain_ms=g["plain_ms"],
                 bound_ms=g["bound_ms"], bound_by=g["bound_by"],
                 bound_fp32_ms=g["bound_fp32_ms"], library_ms=None)
            for g in gabs if (g["BH"], g["n"], g["dh"]) in BWD_FAMILIES and g["n"] == 4096]
    return dict(
        name="gated_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/gated_attention_bwd.cu",
        gradient_of="the reference differentiates plain JAX σ attention "
                    "(src/repro/models/attention.py:114, USE_PALLAS_SIGMA = False)",
        launches=launches, max_abs_err=max(g["max_abs_err"] for g in gabs),
        max_rel_err=max(e for g in gabs for e in g["rel_err"].values()),
        ms=gab["ms"], plain_ms=gab["plain_ms"], bound_ms=gab["bound_ms"],
        bound_by=gab["bound_by"], library_ms=None, BH=96, n=1024, cores=gab["cores"],
        dkv_ms=gab["dkv_ms"], dq_ms=gab["dq_ms"], bound_fp32_ms=gab["bound_fp32_ms"],
        bound_tc_3xtf32_ms=gab["bound_tc_3xtf32_ms"], head_dims=rows)


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
    ``top`` kernels by device time, and the count of device records (kernels
    and copies) it traced. Only the device's activity is traced:
    host-op records would lengthen the wall time the idle share is taken
    over, and their post-processing outlasts a traced forward of tens of
    thousands of launches many times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_launches=sum(e.count for e in dev), kernels=by_name,
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


def first_layer_flips(diff: torch.Tensor, gaps, tie: float, what: str) -> int:
    """The near-tie rule for two routes' VQ codes: 0 when ``diff`` ([L, ...]
    bool, where the codes differ) is all False. Otherwise every difference
    in the earliest layer that has one must be a near tie: ``gaps(layer)``
    yields each route's top-two score gaps there, shaped like
    ``diff[layer]``, and a difference is exempt where either lies within
    ``tie`` (later layers inherit the flip). Returns that layer's count of
    flips, else raises."""
    if not bool(diff.any()):
        return 0
    first = int(diff.flatten(1).any(-1).nonzero()[0])
    near = torch.zeros_like(diff[first])
    for gap in gaps(first):
        near |= gap.to(near.device) <= tie
    if bool((diff[first] & ~near).any()):
        raise AssertionError(f"{what}: codes differ at layer {first} away from near-ties")
    return int(diff[first].sum())


def code_diff(srv_a, srv_b, did: str, vq_bias, tie: float = 1e-5) -> int:
    """``first_layer_flips`` on the two servers' codes for ``did``, the
    gaps from each server's own T (its VQ scores)."""
    sa, sb = srv_a.state(did), srv_b.state(did)
    sb = type(sb)(*(leaf.to(sa.x.device) for leaf in sb))
    diff = (sa.codes != sb.codes) & sa.valid[None, :, None]
    hq, Q = vq_bias.shape[1:]
    n = sa.tokens.shape[0]

    def gaps(first):
        for st in (sa, sb):
            causal = ((st.positions[None, :] <= st.positions[:, None]) & st.valid[None, :])
            counts = causal.float().sum(-1).clamp(min=1.0)
            s = (st.T[first].reshape(n, hq, -1, Q).sum(2) / counts[:, None, None]
                 + vq_bias[first])
            top2 = s.topk(2, dim=-1).values
            yield top2[..., 0] - top2[..., 1]

    return first_layer_flips(diff, gaps, tie, did)


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
    anonymous namespace's per-file tag is cut from the names, and each
    instruction line's runs of blanks are taken as one: cuobjdump pads its
    columns to the widest line of the library, so a kernel added beside
    another would change the other's hash."""
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
                funcs[name].update(" ".join(line.split()).encode())
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
    logits must match the engine's full forward within 3e-4, unless a VQ
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
        elif d > 3e-4:
            raise AssertionError(f"forward: {did} last-row logits differ by {d} (3e-4)")
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
    from repro_torch.serving import spans
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.suggest import SuggestionEngine, oracle_suggestion
    from repro_torch.core.edits import Edit

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
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
    # host ms of each real refresh, ending at the continuation's host read
    refresh_ms = [(s.end - s.start) * 1e3 for s in spans.between(t_phase, time.perf_counter())
                  if s.name == "refresh" and s.key in srv.docs]
    return dict(suggestions_checked=checked, near_tie_suggestions=near_ties,
                vq_assign_launches=vq_launches,
                headroom_defrags=st.suggest_headroom_defrags,
                refreshes=st.suggest_refreshes, refresh_ms_median=float(np.median(refresh_ms)),
                refresh_ms_max=max(refresh_ms),
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
            if logit_diff[did] > 3e-4:
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
    # a replica a card where there are two
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else DEVICE
    fleet = FleetRouter(2, smoke=smoke, seed=0, cold_dir=cold, device=devices,
                        max_batch_delay_ms=5.0)
    boot_s = time.perf_counter() - t0
    out = dict(boot_s=boot_s, worker_boot_s=[r.boot_s for r in fleet.replicas],
               devices=devices)
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


# ------------------------------------------------------------ op counting

NEAR_TIE = 1e-4  # top-two VQ scores this close may flip between two routes


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def engine_scores(eng, st, li: int, rows=None) -> torch.Tensor:
    """The op-counting engine's VQ scores [n, hq, Q] at layer ``li`` of
    ``st`` (its ``_codes_of`` before the argmax); ``rows`` picks and orders
    the rows of a slot buffer, whose row of sequence rank i attends i + 1
    columns."""
    T = st.T[li] if rows is None else st.T[li][rows]
    n = T.shape[0]
    counts = torch.arange(1, n + 1, dtype=torch.float32, device=T.device)
    return (T.reshape(n, eng.hq, eng.heads_per_vq, eng.Q).sum(2) / counts[:, None, None]
            + eng.layers[li]["vq_bias"].to(T.device))


class _Layers:
    """A ``DocState``'s per-layer tensors as stacks, for ``engine_scores``."""

    def __init__(self, state):
        self.T = [l.T for l in state.layers]
        self.codes = torch.stack([l.codes for l in state.layers]).cpu()


def near_tie_flips(eng, a, b, what: str, rows_a=None, rows_b=None) -> int:
    """``first_layer_flips`` (within ``NEAR_TIE``) on the codes of ``a`` and
    ``b`` (``_Layers`` or slot states read at ``rows_*``), the gaps from the
    op-counting engine's scores of each."""
    ca = a.codes if rows_a is None else a.codes[:, rows_a].cpu()
    cb = b.codes if rows_b is None else b.codes[:, rows_b].cpu()

    def gaps(first):
        for st, rows in ((a, rows_a), (b, rows_b)):
            top2 = engine_scores(eng, st, first, rows).topk(2, dim=-1).values.cpu()
            yield top2[..., 0] - top2[..., 1]

    return first_layer_flips(ca != cb, gaps, NEAR_TIE, what)


def incremental_phase(params, cfg, docs: dict, stream, srv, device=None,
                      twin: str = "d256") -> dict:
    """The paper's measurement path on ``device``: the documents opened in
    an op-counting ``IncrementalServer`` and the stream applied as atomic
    edits in its order, each edit's counted ops beside the dense
    from-scratch cost and its host-clock ms (synchronized). Then every
    document's final state against the engine's own ``full_forward``
    (codes equal but for near ties; where none flipped, logits within 3e-4
    and the last layer's states within 5e-5), the batch server
    ``srv``'s slot codes and logits against the same engine's full forward
    of its tokens and positions, and the ``twin`` document's edits replayed
    in step on a CPU server: each edit's op count equal, or its first
    diverging code a near tie (the twin then takes the device's state)."""
    from repro_torch.core.edits import apply_edits
    from repro_torch.serving.engine import IncrementalServer

    device = device or DEVICE
    server = IncrementalServer(params, cfg, device=device)
    eng = server.engine
    for did, toks in docs.items():
        server.open_document(did, toks)
    ops_open = server.stats.incremental_ops
    cpu = IncrementalServer(params, cfg, device="cpu")
    cpu.open_document(twin, docs[twin])
    per_edit, twin_diverged = [], []
    for batch in stream:
        for did, e in batch:
            sync(device)
            t0 = time.perf_counter()
            ops = server.apply_edit(did, e)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            per_edit.append(dict(doc=did, op=e.op, ops=ops, ms=ms,
                                 dense=server._dense_ops(server.docs[did].state.n)))
            if did != twin:
                continue
            cpu_ops = cpu.apply_edit(did, e)
            here, there = server.docs[did], cpu.docs[did]
            if here.allocator.positions != there.allocator.positions:
                raise AssertionError("incremental: the CPU twin's position ids differ")
            flips = near_tie_flips(eng, _Layers(here.state), _Layers(there.state),
                                   f"incremental: the CPU twin after edit {len(per_edit) - 1}")
            if flips:
                twin_diverged.append(dict(edit=len(per_edit) - 1, flips=flips,
                                          ops=ops, cpu_ops=cpu_ops))
                there.state = here.state.to("cpu")  # step on from the same state
            elif cpu_ops != ops:
                raise AssertionError(f"incremental: edit {len(per_edit) - 1} counted "
                                     f"{ops} ops on {device} and {cpu_ops} on the CPU")
    st = server.stats
    ratios = [p["dense"] / max(p["ops"], 1) for p in per_edit]
    ms = [p["ms"] for p in per_edit]

    exact = {}
    for did, toks in docs.items():
        replay = apply_edits(toks, [e for batch in stream for d, e in batch if d == did])
        state = server.docs[did].state
        if list(state.tokens) != replay:
            raise AssertionError(f"incremental: {did} tokens differ from the host replay")
        full = eng.full_forward(state.tokens, state.positions)
        flips = near_tie_flips(eng, _Layers(state), _Layers(full), f"incremental: {did}")
        row = dict(n=state.n, flips=flips,
                   max_abs_x_diff=float((state.xs[-1] - full.xs[-1]).abs().max()),
                   logits_diff=float((eng.logits_at(state) - eng.logits_at(full)).abs().max()))
        if not flips and row["logits_diff"] > 3e-4:
            raise AssertionError(f"incremental: {did} logits differ by {row['logits_diff']}")
        if not flips and row["max_abs_x_diff"] > 5e-5:
            raise AssertionError(
                f"incremental: {did} states differ by {row['max_abs_x_diff']} (5e-5)")
        exact[did] = row

    oracle = {}
    for did in docs:
        doc, slot_state = srv.docs[did], srv.state(did)
        full = eng.full_forward(doc.seq_tokens(), doc.seq_positions())
        slots = torch.as_tensor(doc.slots, device=slot_state.codes.device)
        flips = near_tie_flips(eng, slot_state, _Layers(full), f"incremental: BatchServer {did}",
                               rows_a=slots)
        d = float(np.abs(srv.logits(did) - eng.logits_at(full).cpu().numpy()).max())
        if not flips and d > 3e-4:
            raise AssertionError(f"incremental: BatchServer {did} logits differ by {d}")
        oracle[did] = dict(n=doc.n, flips=flips, logits_diff=d)

    return dict(edits=len(per_edit), ops_open=ops_open,
                ops_edits=sum(p["ops"] for p in per_edit),
                dense_edits=sum(p["dense"] for p in per_edit),
                incremental_ops=st.incremental_ops, full_ops_equiv=st.full_ops_equiv,
                speedup=st.speedup, ratio_median=float(np.median(ratios)),
                ratio_min=float(min(ratios)), ratio_max=float(max(ratios)),
                defrags=st.defrags, ms_per_edit_median=float(np.median(ms)),
                ms_per_edit_max=float(max(ms)), exactness=exact, batch_server_oracle=oracle,
                cpu_twin=dict(doc=twin, edits=sum(p["doc"] == twin for p in per_edit),
                              near_tie_divergences=twin_diverged),
                per_edit=[[p["doc"], p["op"], p["ops"], p["dense"], round(p["ms"], 3)]
                          for p in per_edit])


# ------------------------------------------------------------ the mesh


def default_mesh() -> list:
    """Phase 15's blocks: one a card where there are 2 to 4 cards (2 of 3:
    ``max_batch`` 8 needs a power of two), else 2 blocks on the one card."""
    count = torch.cuda.device_count()
    if count >= 2:
        return [f"cuda:{i}" for i in range(4 if count >= 4 else 2)]
    return ["cuda:0"] * 2


def mesh_phase(params, cfg, docs: dict, stream, mesh=None, device=None, n_new: int = 8,
               sub: str = "d256") -> dict:
    """The serve stream with an ``n_new``-token subscription on ``sub``
    through ``BatchServer(mesh=mesh, max_batch=8)`` (k blocks), against a
    ``BatchServer(device=device)`` on the same stream: tokens equal (and
    equal the host replay), ``edits_applied`` equal, slot codes equal but
    for near ties (top-two scores within ``NEAR_TIE``; counted), logits
    within 3e-4 where no code flipped, the suggestion equal to
    ``oracle_suggestion`` (or differing first at a near tie of the
    oracle's logits, counted), ``sharded_dispatches > 0``, 12 × k
    ``fused_step`` launches an edit dispatch, one weight replica per
    distinct device, and no state move when every block is on one device.
    Then a one-entry mesh on the same stream is bitwise the single-device
    server: every state leaf, ``logits()`` and the suggestion."""
    from repro_torch.core.edits import apply_edits
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.serving.suggest import oracle_suggestion

    device = device or DEVICE
    mesh = mesh or default_mesh()
    k, devices = len(mesh), list(dict.fromkeys(str(d) for d in mesh))
    on_card = torch.device(device).type == "cuda"

    def run(**kw):
        srv = BatchServer(params, cfg, max_batch=8, **kw)
        srv.open_documents({d: list(t) for d, t in docs.items()})
        srv.submit_suggest(sub, n_new)
        seconds = 0.0
        for batch in stream:
            for did, e in batch:
                srv.submit_edit(did, e)
            t0 = time.perf_counter()
            srv.flush()
            for d in devices:
                sync(d)
            seconds += time.perf_counter() - t0
        return srv, seconds

    one, one_s = run(device=device)
    if on_card:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    base_mem = {d: torch.cuda.memory_allocated(d) for d in devices} if on_card else {}
    reset_launches()
    with fused_step_census() as census:
        srv, mesh_s = run(mesh=mesh)
    launches = launch_counters()[1]()
    st = srv.stats
    if srv.n_shards != k or st.sharded_dispatches < 1:
        raise AssertionError(f"mesh: {st.sharded_dispatches} sharded dispatches over {k} blocks")
    want = n_layers(cfg) * k * st.batch_steps
    if launches["fused_step"] != want or sum(census.values()) != want:
        raise AssertionError(f"mesh: fused_step launched {launches['fused_step']} times "
                             f"({sum(census.values())} calls) for {st.batch_steps} dispatches "
                             f"of {k} blocks (expected {want})")
    if st.edits_applied != one.stats.edits_applied:
        raise AssertionError(f"mesh: {st.edits_applied} edits applied, the single-device "
                             f"server {one.stats.edits_applied}")
    eng = srv.engine(srv.C, srv.R)
    if sorted(str(d) for d in eng.replicas) != sorted(devices):
        raise AssertionError(f"mesh: weight replicas on {sorted(map(str, eng.replicas))} "
                             f"for the devices {devices}")
    if len(devices) == 1 and st.state_moves:
        raise AssertionError(f"mesh: {st.state_moves} state moves with every block on one device")
    vq_bias = one.engine(one.C, one.R).W["vq_bias"]
    flips, logit_diff = {}, {}
    for did, toks in docs.items():
        replay = apply_edits(toks, [e for batch in stream for d, e in batch if d == did])
        if not (np.array_equal(srv.tokens(did), replay)
                and np.array_equal(one.tokens(did), replay)):
            raise AssertionError(f"mesh: {did} tokens differ from the host replay")
        flips[did] = code_diff(one, srv, did, vq_bias, tie=NEAR_TIE)
        if flips[did] == 0:
            logit_diff[did] = float(np.abs(srv.logits(did) - one.logits(did)).max())
            if logit_diff[did] > 3e-4:
                raise AssertionError(f"mesh: {did} logits differ by {logit_diff[did]}")
    doc = srv.docs[sub]
    got = srv.suggestion(sub)
    ora = oracle_suggestion(srv.suggester.params, cfg, eng, doc.tokens, doc.positions,
                            doc.valid, n_new)
    suggestion_near_tie = None
    if got is None or not np.array_equal(got, ora):
        j = 0 if got is None else int(np.flatnonzero(got != ora)[0])
        suggestion_near_tie = first_token_near_tie(srv.suggester.params, cfg, doc, ora, j)
        if got is None or suggestion_near_tie > NEAR_TIE:
            raise AssertionError(f"mesh: {sub}'s suggestion {got} differs from the oracle's "
                                 f"{ora} (top-two logit gap {suggestion_near_tie})")
    weights = {str(d): tensor_bytes(list(w[:2])) for d, w in eng.replicas.items()}
    peak = ({d: torch.cuda.max_memory_allocated(d) - base_mem[d] for d in devices}
            if on_card else None)
    del srv

    # a one-entry mesh is the single-device path, bit for bit
    m1, _ = run(mesh=[mesh[0]])
    if m1.stats.sharded_dispatches or m1.stats.batch_steps != one.stats.batch_steps:
        raise AssertionError("mesh: the one-entry mesh dispatched otherwise")
    for did in docs:
        for name, a, b in zip(one.state(did)._fields, one.state(did), m1.state(did)):
            if not torch.equal(a, b):
                raise AssertionError(f"mesh: one-entry mesh {did}.{name} is not bitwise")
        if not np.array_equal(one.logits(did), m1.logits(did)):
            raise AssertionError(f"mesh: one-entry mesh {did} logits are not bitwise")
    if not np.array_equal(one.suggestion(sub), m1.suggestion(sub)):
        raise AssertionError("mesh: one-entry mesh suggestion differs")
    return dict(k=k, mesh=[str(d) for d in mesh], max_batch=8,
                edits=st.edits_applied, edit_dispatches=st.batch_steps,
                sharded_dispatches=st.sharded_dispatches,
                mean_shard_imbalance=st.mean_shard_imbalance, state_moves=st.state_moves,
                overflows=st.overflows, grows=st.grows, defrags=st.defrags,
                launches={n: launches[n] for n in ("fused_step", "vq_assign")},
                fused_step_block_shapes=census, near_tie_flips=flips,
                max_logits_diff=logit_diff, suggestion=[int(t) for t in got],
                suggestion_near_tie=suggestion_near_tie,
                edits_per_s_single=one.stats.edits_applied / one_s,
                edits_per_s_mesh=st.edits_applied / mesh_s,
                weight_replica_bytes=weights,
                suggester_weight_bytes=tensor_bytes(m1.suggester.params),
                peak_mem_above_start_bytes=peak, mesh_of_one_bitwise=True)


# ------------------------------------------------------------ the families

# the smoke-size families of phase 16 and their sequence lengths (danube's
# 80 runs past its smoke window of 64, so its ring buffer wraps)
FAMILY_SMOKE = (("stablelm-1.6b", 32), ("h2o-danube-1.8b", 80), ("internvl2-1b", 32),
                ("musicgen-large", 32))


@contextlib.contextmanager
def recorded_codes():
    """Record every ``core.vq.quantize`` call while the block runs: its
    codes and, per (row, VQ head), the gap between the top two plain
    scores. Yields the list of (idx, gap) pairs in call order."""
    from repro_torch.core import vq as vq_mod

    calls = []
    quantize = vq_mod.quantize

    def rec(params, x):
        x_q, idx = quantize(params, x)
        top2 = vq_mod.scores(params, x).topk(2, dim=-1).values
        calls.append((idx, top2[..., 0] - top2[..., 1]))
        return x_q, idx

    vq_mod.quantize = rec
    try:
        yield calls
    finally:
        vq_mod.quantize = quantize


@contextlib.contextmanager
def attention_census():
    """Count the attention routes of ``models.attention.full_attention``
    while the block runs: ``gated_attention`` calls by "BHxnxdh" and
    ``streaming_attention`` calls. Yields the dict that fills."""
    from repro_torch.models import attention

    census = {"gated_attention": {}, "streaming": 0}
    kernel, stream = attention.gated_attention, attention.streaming_attention

    def counted_kernel(q, k, v):
        key = f"{q.shape[0] * q.shape[2]}x{q.shape[1]}x{q.shape[3]}"
        census["gated_attention"][key] = census["gated_attention"].get(key, 0) + 1
        return kernel(q, k, v)

    def counted_stream(*a, **kw):
        census["streaming"] += 1
        return stream(*a, **kw)

    with mock.patch.object(attention, "gated_attention", counted_kernel), \
            mock.patch.object(attention, "streaming_attention", counted_stream):
        yield census


def code_flips(fwd: list, route: list, L: int, what: str):
    """The VQ codes of a forward (``fwd``: one call a layer over all rows)
    against another route over the same rows (``route``: one call a layer
    for each chunk or decode step, rows in order), held to
    ``first_layer_flips`` within NEAR_TIE. Returns the [b, n] rows with any
    flipped code (None without VQ)."""
    if not fwd:
        return None
    f_idx = torch.stack([c[0] for c in fwd])  # [L, b, n, hq]
    f_gap = torch.stack([c[1] for c in fwd])
    r_idx = torch.stack([torch.cat([c[0] for c in route[li::L]], dim=1) for li in range(L)])
    r_gap = torch.stack([torch.cat([c[1] for c in route[li::L]], dim=1) for li in range(L)])
    diff = f_idx != r_idx
    first_layer_flips(diff, lambda first: (f_gap[first], r_gap[first]), NEAR_TIE, what)
    return diff.any(0).any(-1)


def step_profile(fn) -> dict:
    """One decode step ``fn()`` under torch.profiler: its wall ms, the
    device's busy ms and idle share, and the 5 kernels that take the most
    device time."""
    prof = profiled(fn, ("vq_assign",), top=5)
    return {k: prof[k] for k in ("wall_ms_profiled", "device_busy_ms", "device_idle_share",
                                 "top_kernels")}


def softmax_twin(params: dict, cfg):
    """The published softmax model on a VQT model's weights: (its config,
    the parameter tree without the ``vq`` leaves; no tensor is copied)."""
    soft = dict(params, stages=[
        tuple(dict(lp, mixer={k: t for k, t in lp["mixer"].items() if k != "vq"}) for lp in st)
        for st in params["stages"]])
    return dataclasses.replace(cfg, attn_softmax=True, vqt=None), soft


def rows_close(what: str, got: torch.Tensor, want: torch.Tensor, flipped,
               tol: float = 2e-3) -> dict:
    """``got`` within atol = rtol = ``tol`` of ``want`` (both [b, m, ...])
    in every row whose own VQ codes did not flip (``flipped`` [b, m] or
    None); the reference's prefill / decode bound
    (``tests/test_models.py:85-89``)."""
    bad = ((got - want).abs() > tol + tol * want.abs()).flatten(2).any(-1)
    exempt = torch.zeros_like(bad) if flipped is None else flipped
    if bool((bad & ~exempt).any()):
        raise AssertionError(f"{what}: logits differ by {float((got - want).abs().max())} "
                             f"(atol = rtol = {tol}) in a row without a code flip")
    keep = ~exempt
    return dict(max_logits_diff=float((got - want).abs()[keep].max()) if keep.any() else None,
                near_tie_rows=int(exempt.sum()))


def phi4_phase(cfg=None, n: int = 4096, chunk: int = 1024, n_dec: int = 16,
               device=None) -> dict:
    """phi4-mini-3.8B with VQT at full width and depth (32 layers, d 3072,
    24 / 8 heads of 128, vocab 200,064), weights drawn on the card from
    seed 0: ``forward`` on [1, n] random tokens (``gated_attention`` at
    BH = 24, n, dh = 128 and ``vq_assign`` once a layer; finite logits),
    timed and profiled; then ``prefill_step`` of the first n - n_dec
    tokens in chunks of ``chunk`` and ``n_dec`` ``decode_step``s, whose
    logits match the forward's last rows within 2e-3 but where a row's own
    code flipped at a near tie; the same prefill and decode again with no
    codes recorded, timed, and one more decode step profiled; then the
    softmax model on the same weights
    (no VQ leaves, no copy): its forward streams (``flash``) in every layer,
    and on layer 0's q / k / v ``streaming_attention`` matches
    ``attention_core`` within 2e-5 (``tests/test_models.py:130-133``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_tokens
    from repro_torch.models.norms import apply_norm

    device = torch.device(device or DEVICE)
    on_card = device.type == "cuda"
    cfg = cfg or get_config("phi4-mini-3.8b", vqt=True)
    L = n_layers(cfg)
    # device memory (GB): allocated at the start (what earlier phases hold),
    # then the peak so far after each step
    peak_gb = lambda: torch.cuda.max_memory_allocated() / 1e9 if on_card else None  # noqa: E731
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    peaks = {"start": torch.cuda.memory_allocated() / 1e9 if on_card else None}
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    peaks["init"] = peak_gb()
    param_bytes = tensor_bytes(params)  # every leaf f32
    tokens = torch.randint(0, cfg.vocab, (1, n), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    pos = torch.arange(n, dtype=torch.int32, device=device)[None]

    reset_launches()
    with attention_census() as census, recorded_codes() as fwd_codes:
        t0 = time.perf_counter()
        logits, _ = T.forward(params, cfg, tokens)
        sync(device)
        forward_s = time.perf_counter() - t0
    launches = launch_counters()[1]()
    dh = cfg.resolved_head_dim
    want_shape = {f"{cfg.n_heads}x{n}x{dh}": L}
    if (launches["gated_attention"] != L or launches["vq_assign"] != L
            or census["gated_attention"] != want_shape or census["streaming"]):
        raise AssertionError(f"families: phi4 forward launched {launches} with attention "
                             f"routes {census} (expected {want_shape} and {L} vq_assign)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("families: phi4 forward logits are not finite")
    want = logits[:, n - n_dec:].clone()
    del logits
    peaks["forward"] = peak_gb()
    call = lambda: T.forward(params, cfg, tokens)  # noqa: E731
    ms = time_ms(call, warmup=1, iters=3)
    prof = profiled(call, ("gated_attention", "vq_assign"), top=5)
    peaks["timed_forwards"] = peak_gb()

    # prefill and decode with their VQ codes recorded, for the gates
    caches = T.init_caches(cfg, 1, n, device=device)
    with recorded_codes() as route_codes:
        for s in range(0, n - n_dec, chunk):
            e = min(s + chunk, n - n_dec)
            _, caches = T.prefill_step(params, cfg, tokens[:, s:e], caches, pos[:, s:e])
        got = []
        for i in range(n - n_dec, n):
            step, caches = T.decode_step(params, cfg, tokens[:, i:i + 1], caches, pos[:, i:i + 1])
            got.append(step)
    peaks["prefill_decode"] = peak_gb()
    del caches
    flipped = code_flips(fwd_codes, route_codes, L, "families: phi4 prefill/decode")
    dec = rows_close("families: phi4 prefill/decode", torch.cat(got, dim=1), want,
                     None if flipped is None else flipped[:, n - n_dec:])
    del got, fwd_codes, route_codes
    # the same again with nothing recorded, timed; the cache has one slot
    # more for one decode step under torch.profiler
    caches = T.init_caches(cfg, 1, n + 1, device=device)
    sync(device)
    t0 = time.perf_counter()
    for s in range(0, n - n_dec, chunk):
        e = min(s + chunk, n - n_dec)
        _, caches = T.prefill_step(params, cfg, tokens[:, s:e], caches, pos[:, s:e])
    sync(device)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n - n_dec, n):
        _, caches = T.decode_step(params, cfg, tokens[:, i:i + 1], caches, pos[:, i:i + 1])
    sync(device)
    decode_s = time.perf_counter() - t0
    step_prof = step_profile(lambda: T.decode_step(params, cfg, tokens[:, -1:], caches,
                                                   pos[:, -1:] + 1))
    del caches

    soft_cfg, soft = softmax_twin(params, cfg)
    reset_launches()
    with attention_census() as soft_census:
        t0 = time.perf_counter()
        logits, _ = T.forward(soft, soft_cfg, tokens)
        sync(device)
        soft_s = time.perf_counter() - t0
    soft_launches = launch_counters()[1]()
    if (soft_census["streaming"] != L or soft_census["gated_attention"]
            or soft_launches["vq_assign"] or soft_launches["gated_attention"]):
        raise AssertionError(f"families: phi4 softmax forward took routes {soft_census} "
                             f"and launched {soft_launches} (expected {L} streamed layers)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("families: phi4 softmax logits are not finite")
    del logits
    peaks["softmax_forward"] = peak_gb()
    lp = T._index(soft["stages"][0], 0)[0]
    h = apply_norm(soft_cfg.norm, lp["norm1"], embed_tokens(soft["embed"], soft_cfg, tokens, pos))
    q, k, v = attention._qkv(lp["mixer"], soft_cfg, h, pos)
    stream = attention.streaming_attention(q, k, v, causal=True, softmax=True)
    dense = attention.attention_core(q, k, v, attention.make_mask(
        n, n, causal=True, window=None, device=device), softmax=True)
    stream_err = float((stream - dense).abs().max())
    if not torch.allclose(stream, dense, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"families: phi4 layer 0 streaming attention differs from the "
                             f"dense core by {stream_err} (atol = rtol = 2e-5)")
    del q, k, v, stream, dense, h, soft
    peaks["layer0_dense_check"] = peak_gb()
    del params
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
                head_dim=dh, vocab=cfg.vocab, params=param_bytes // 4, param_bytes=param_bytes,
                tokens=n, init_params_s=init_s, init_on=str(device), first_forward_s=forward_s,
                ms_per_forward=ms, tokens_per_s=n / (ms / 1e3),
                launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                attention_routes=census, profile=dict(
                    device_busy_ms=prof["device_busy_ms"], wall_ms_profiled=prof["wall_ms_profiled"],
                    device_idle_share=prof["device_idle_share"], kernels=prof["kernels"],
                    top_kernels=prof["top_kernels"]),
                prefill=dict(tokens=n - n_dec, chunk=chunk, seconds=prefill_s),
                decode=dict(steps=n_dec, seconds=decode_s, ms_per_step=decode_s / n_dec * 1e3,
                            step_profile=step_prof, **dec),
                softmax=dict(seconds=soft_s, attention_routes=soft_census,
                             layer0_streaming_vs_dense_max_abs_err=stream_err),
                mem_gb=peaks)


def gemma3_phase(cfg=None, n_fwd: int = 3072, n_dec: int = 1100, device=None) -> dict:
    """gemma3-12b with VQT at full width (d 3840, 16 / 8 heads of 256,
    d_ff 15,360, vocab 262,144, tied), depth cut to one 5-local : 1-global
    pattern (6 layers). ``forward`` on [1, n_fwd]: the five windowed σ
    layers stream, the global one launches ``gated_attention`` at dh = 256;
    then ``decode_step`` token by token over n_dec tokens, past the
    1024-slot ring of the local layers: its last logits match a [1, n_dec]
    forward within 2e-3 unless the row's own code flipped at a near tie;
    the decode again with no codes recorded, timed, and one more step
    profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    device = torch.device(device or DEVICE)
    if cfg is None:
        full = get_config("gemma3-12b", vqt=True)
        pattern = full.stages[0][0]
        cfg = dataclasses.replace(full, n_layers=len(pattern),
                                  stages=((pattern, 1),)).validate()
    L = n_layers(cfg)
    n_local = sum(layer.window is not None for layer in cfg.layer_list())
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    param_bytes = tensor_bytes(params)  # every leaf f32
    tokens = torch.randint(0, cfg.vocab, (1, n_fwd), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    with attention_census() as census:
        t0 = time.perf_counter()
        logits, _ = T.forward(params, cfg, tokens)
        sync(device)
        forward_s = time.perf_counter() - t0
    launches = launch_counters()[1]()
    dh = cfg.resolved_head_dim
    want_shape = {f"{cfg.n_heads}x{n_fwd}x{dh}": L - n_local}
    if (census["gated_attention"] != want_shape or launches["gated_attention"] != L - n_local
            or census["streaming"] != n_local or launches["vq_assign"] != L):
        raise AssertionError(f"families: gemma3 forward launched {launches} with attention "
                             f"routes {census} (expected {want_shape}, {n_local} streamed)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("families: gemma3 forward logits are not finite")
    del logits
    ms = time_ms(lambda: T.forward(params, cfg, tokens), warmup=1, iters=3)

    toks = tokens[:, :n_dec]
    with recorded_codes() as fwd_codes:
        want = T.forward(params, cfg, toks)[0][:, -1:]
    caches = T.init_caches(cfg, 1, n_dec, device=device)
    ring = [c["mix"]["k"].shape[2] for st in caches for c in st]
    with recorded_codes() as route_codes:
        for i in range(n_dec):
            step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                         torch.full((1, 1), i, dtype=torch.int32, device=device))
    flipped = code_flips(fwd_codes, route_codes, L, "families: gemma3 decode")
    dec = rows_close("families: gemma3 decode", step, want,
                     None if flipped is None else flipped[:, -1:])
    del caches, fwd_codes, route_codes
    # the same again with nothing recorded, timed, and one more step profiled
    caches = T.init_caches(cfg, 1, n_dec + 1, device=device)
    sync(device)
    t0 = time.perf_counter()
    for i in range(n_dec):
        _, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                  torch.full((1, 1), i, dtype=torch.int32, device=device))
    sync(device)
    decode_s = time.perf_counter() - t0
    step_prof = step_profile(lambda: T.decode_step(
        params, cfg, toks[:, -1:], caches,
        torch.full((1, 1), n_dec, dtype=torch.int32, device=device)))
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del params, caches
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, reduced="depth 48 -> 6: one 5-local : 1-global pattern",
                d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=dh,
                vocab=cfg.vocab, params=param_bytes // 4, param_bytes=param_bytes, tokens=n_fwd,
                init_params_s=init_s, first_forward_s=forward_s, ms_per_forward=ms,
                tokens_per_s=n_fwd / (ms / 1e3),
                launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                attention_routes=census, cache_slots=ring,
                decode=dict(steps=n_dec, seconds=decode_s, ms_per_step=decode_s / n_dec * 1e3,
                            step_profile=step_prof, **dec),
                mem_gb=dict(start=start_gb, peak=peak))


def smoke_families(device=None, families=FAMILY_SMOKE) -> dict:
    """stablelm, h2o-danube, internvl2 (8 patch embeddings) and musicgen (4
    codebooks) at smoke size, both variants, seeded weights: the forward's
    routes (``gated_attention`` once an unwindowed σ layer, ``vq_assign``
    once a VQ layer), and token-by-token decode whose last logits match the
    forward within 2e-3 unless a code flipped at a near tie (internvl2 on
    its text, after a finite forward with its vision prefix)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    device = torch.device(device or DEVICE)
    out = {}
    for arch, n in families:
        for vqt in (False, True):
            cfg = get_config(arch, smoke=True, vqt=vqt)
            params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device=device)
            gen = torch.Generator().manual_seed(1)
            b = 2
            shape = (b, n, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, n)
            toks = torch.randint(0, cfg.vocab, shape, generator=gen).to(device)
            step_ids = torch.arange(n, dtype=torch.int32)[None].repeat(b, 1)
            pos = (step_ids * 3 if cfg.pos in ("learned", "sampled") else step_ids).to(device)
            res = {}
            if cfg.input_mode == "vlm":
                patches = torch.randn((b, 8, cfg.d_model), generator=gen).to(device)
                lg, _ = T.forward(params, cfg, toks, pos, patch_embeds=patches)
                if lg.shape != (b, 8 + n, cfg.vocab) or not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"families: {arch} vision forward gave {tuple(lg.shape)}")
                res["vision_logits"] = list(lg.shape)
                cfg = dataclasses.replace(cfg, input_mode="tokens")
            reset_launches()
            with recorded_codes() as fwd_codes:
                full, _ = T.forward(params, cfg, toks, pos)
            launches = launch_counters()[1]()
            sigma_global = sum(layer.window is None for layer in cfg.layer_list()) if vqt else 0
            want = dict(gated_attention=sigma_global, vq_assign=n_layers(cfg) if vqt else 0)
            if {k: launches[k] for k in want} != want:
                raise AssertionError(f"families: {arch} vqt={vqt} forward launched "
                                     f"{launches} (expected {want})")
            if not bool(torch.isfinite(full).all()):
                raise AssertionError(f"families: {arch} vqt={vqt} logits are not finite")
            caches = T.init_caches(cfg, b, n, device=device)
            with recorded_codes() as route_codes:
                for i in range(n):
                    step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                                 pos[:, i:i + 1])
            what = f"families: {arch} vqt={vqt} decode"
            flipped = code_flips(fwd_codes, route_codes, n_layers(cfg), what)
            res.update(tokens=n, launches=want, **rows_close(
                what, step, full[:, -1:], None if flipped is None else flipped[:, -1:]))
            out[f"{arch}{'+vqt' if vqt else ''}"] = res
    return out


# ------------------------------------------------------- the recurrent families


def scan_check(ops: tuple, what: str, **kw) -> dict:
    """The chunked scan against the sequential one on the same operands
    (q, k, v, logw, zero-padded to a multiple of the chunk as the mixers
    pad them; ``kw``: u, mamba_style), within 1e-4
    (``tests/test_models.py:150-151``), and the chunked scan's ms a call
    (CUDA events; its chunk loop is host launches, so the events' span
    holds the gaps between them)."""
    from repro_torch.models import linear_scan

    pad = -ops[0].shape[2] % linear_scan.CHUNK
    args = tuple(torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in ops)
    chunked, sequential = linear_scan.lin_attn_chunked, linear_scan.lin_attn_sequential
    yc, sc = chunked(*args, **kw)
    ys, ss = sequential(*args, **kw)
    err = max(float((yc - ys).abs().max()), float((sc - ss).abs().max()))
    if not (torch.allclose(yc, ys, atol=1e-4, rtol=1e-4)
            and torch.allclose(sc, ss, atol=1e-4, rtol=1e-4)):
        raise AssertionError(f"recurrent: {what} chunked scan differs from the sequential "
                             f"one by {err} (atol = rtol = 1e-4)")
    del yc, sc, ys, ss
    return dict(chunked_vs_sequential_max_abs_err=err,
                chunks=args[0].shape[2] // linear_scan.CHUNK,
                chunked_scan_ms=time_ms(lambda: chunked(*args, **kw), warmup=1, iters=5))


def stopwatch():
    """(laps, lap): ``lap(name)`` stores in ``laps`` the host seconds since
    the previous lap (or the stopwatch's start) under ``name``."""
    laps, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    return laps, lap


def rwkv6_phase(cfg=None, n: int = 4096, n_dec: int = 64, device=None) -> dict:
    """rwkv6-7b at full width and depth (32 layers, d 4096, 64 heads of 64,
    d_ff 14,336, vocab 65,536), weights drawn on the card from seed 0:
    ``forward`` on [1, n] random tokens (no kernel of the port's: no
    attention, no VQ; finite logits), timed and profiled; layer 0's
    time-mix operands through the chunked and the sequential scan (within
    1e-4), the chunked scan timed; then ``decode_step`` over n_dec tokens
    from an empty state, the last step's logits within 2e-3 of a [1, n_dec]
    forward (``tests/test_models.py:85-89``; every step's difference is
    reported, and row 0's between a [1, 1] and the [1, n_dec] forward),
    timed, and one more step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_tokens
    from repro_torch.models.norms import apply_norm

    device = torch.device(device or DEVICE)
    on_card = device.type == "cuda"
    cfg = cfg or get_config("rwkv6-7b")
    L = n_layers(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    laps, lap = stopwatch()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    lap("init")
    param_bytes = tensor_bytes(params)  # every leaf f32
    tokens = torch.randint(0, cfg.vocab, (1, n), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = T.forward(params, cfg, tokens)
    sync(device)
    forward_s = time.perf_counter() - t0
    launches = launch_counters()[1]()
    if any(launches.values()):
        raise AssertionError(f"recurrent: the rwkv6 forward launched {launches} (expected none)")
    if logits.shape != (1, n, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"recurrent: rwkv6 forward logits {tuple(logits.shape)} are not "
                             "all finite")
    del logits
    call = lambda: T.forward(params, cfg, tokens)  # noqa: E731
    lap("first_forward")
    ms = time_ms(call, warmup=0, iters=2)
    lap("timed_forwards")
    prof = profiled(call, (), top=6)
    lap("profiled_forward")

    # layer 0's time-mix operands: chunked against sequential
    lp = T._index(params["stages"][0], 0)[0]
    h = apply_norm(cfg.norm, lp["norm1"], embed_tokens(params["embed"], cfg, tokens, None))
    r, k, v, logw, _, u = rwkv6._time_mix_ops(lp["mixer"], cfg, h, rwkv6._token_shift(h))
    scan = scan_check((r, k, v, logw), "rwkv6 layer 0", u=u)
    del h, r, k, v, logw
    lap("layer0_scan")

    toks = tokens[:, :n_dec]
    want = T.forward(params, cfg, toks)[0]
    caches = T.init_caches(cfg, 1, n_dec, device=device)
    got = []
    sync(device)
    t0 = time.perf_counter()
    for i in range(n_dec):
        step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                     torch.full((1, 1), i, dtype=torch.int32, device=device))
        got.append(step)
    sync(device)
    decode_s = time.perf_counter() - t0
    got = torch.cat(got, dim=1)
    dec = rows_close("recurrent: rwkv6 decode", got[:, -1:], want[:, -1:], None)
    row_err = (got - want).abs().amax(-1)[0]  # [n_dec], by step
    # the first token through a [1, 1] forward: the same arithmetic as row 0
    # of the [1, n_dec] one but for the products' shapes (their float order)
    first = T.forward(params, cfg, toks[:, :1])[0]
    dec.update(max_logits_diff_by_step=[float(e) for e in row_err],
               max_logits_abs=float(want.abs().max()),
               row0_forward_1_vs_forward_n_dec=float((first - want[:, :1]).abs().max()))
    step_prof = step_profile(lambda: T.decode_step(
        params, cfg, toks[:, -1:], caches,
        torch.full((1, 1), n_dec, dtype=torch.int32, device=device)))
    lap("decode")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del params, caches, got, want
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, d_model=cfg.d_model,
                heads=cfg.d_model // cfg.rwkv.head_dim, head_dim=cfg.rwkv.head_dim,
                d_ff=cfg.d_ff, vocab=cfg.vocab,
                params=param_bytes // 4, param_bytes=param_bytes, tokens=n,
                init_params_s=laps["init"], first_forward_s=forward_s, ms_per_forward=ms,
                tokens_per_s=n / (ms / 1e3),
                profile=dict(device_busy_ms=prof["device_busy_ms"],
                             wall_ms_profiled=prof["wall_ms_profiled"],
                             device_idle_share=prof["device_idle_share"],
                             top_kernels=prof["top_kernels"]),
                layer0_scan=dict(scan, scan_ms_all_layers_share_of_forward=(
                    L * scan["chunked_scan_ms"] / ms)),
                decode=dict(steps=n_dec, seconds=decode_s, ms_per_step=decode_s / n_dec * 1e3,
                            step_profile=step_prof, **dec),
                mem_gb=dict(start=start_gb, peak=peak), step_seconds=laps)


def hymba_phase(cfg=None, n: int = 4096, n_dec: int = 64, device=None) -> dict:
    """hymba-1.5b with VQT at full width and depth (32 layers, d 1600, 25 /
    5 heads of 64, 3 global layers), weights drawn on the card from seed 0:
    ``forward`` on [1, n] random tokens — ``gated_attention`` at BH = 25,
    n, dh = 64 in each global layer, the windowed σ layers streamed past
    ``STREAM_THRESHOLD``, ``vq_assign`` at dv = 800 in every layer; finite
    logits — timed and profiled; layer 0's SSM operands through the chunked
    and the sequential scan (within 1e-4); then ``decode_step`` over n_dec
    tokens from empty caches, every step's logits within 2e-3 of a
    [1, n_dec] forward but where a row's own VQ code flipped at a near tie;
    then the softmax model on the same weights (no VQ leaves): a forward
    with finite logits, every layer streamed."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, hymba
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_tokens
    from repro_torch.models.norms import apply_norm

    device = torch.device(device or DEVICE)
    on_card = device.type == "cuda"
    cfg = cfg or get_config("hymba-1.5b", vqt=True)
    L = n_layers(cfg)
    n_global = sum(layer.window is None for layer in cfg.layer_list())
    streamed = (L - n_global) if n > attention.STREAM_THRESHOLD else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    laps, lap = stopwatch()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    lap("init")
    param_bytes = tensor_bytes(params)  # every leaf f32
    tokens = torch.randint(0, cfg.vocab, (1, n), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    with attention_census() as census:
        t0 = time.perf_counter()
        logits, _ = T.forward(params, cfg, tokens)
        sync(device)
        forward_s = time.perf_counter() - t0
    launches = launch_counters()[1]()
    dh = cfg.resolved_head_dim
    want_shape = {f"{cfg.n_heads}x{n}x{dh}": n_global}
    if (census["gated_attention"] != want_shape or launches["gated_attention"] != n_global
            or census["streaming"] != streamed or launches["vq_assign"] != L):
        raise AssertionError(f"recurrent: hymba forward launched {launches} with attention "
                             f"routes {census} (expected {want_shape}, {streamed} streamed, "
                             f"{L} vq_assign)")
    if logits.shape != (1, n, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("recurrent: hymba forward logits are not finite")
    del logits
    call = lambda: T.forward(params, cfg, tokens)  # noqa: E731
    lap("first_forward")
    ms = time_ms(call, warmup=0, iters=2)
    lap("timed_forwards")
    prof = profiled(call, ("gated_attention", "vq_assign"), top=6)
    lap("profiled_forward")

    # layer 0's SSM operands: chunked against sequential (zero-padded to the chunk)
    lp = T._index(params["stages"][0], 0)[0]
    h = apply_norm(cfg.norm, lp["norm1"], embed_tokens(params["embed"], cfg, tokens, None))
    xs, _ = (h @ lp["mixer"]["w_xz"]).chunk(2, dim=-1)
    xc, _ = hymba._causal_conv(lp["mixer"], xs)
    qs, ks, vs, logw = hymba._ssm_qkv(lp["mixer"], cfg, xc, h)
    scan = scan_check((qs, ks, vs, logw), "hymba layer 0", mamba_style=True)
    del h, xs, xc, qs, ks, vs, logw
    lap("layer0_scan")

    toks = tokens[:, :n_dec]
    with recorded_codes() as fwd_codes:
        want = T.forward(params, cfg, toks)[0]
    caches = T.init_caches(cfg, 1, n_dec, device=device)
    got = []
    sync(device)
    t0 = time.perf_counter()
    with recorded_codes() as route_codes:
        for i in range(n_dec):
            step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                         torch.full((1, 1), i, dtype=torch.int32, device=device))
            got.append(step)
    sync(device)
    decode_s = time.perf_counter() - t0
    flipped = code_flips(fwd_codes, route_codes, L, "recurrent: hymba decode")
    dec = rows_close("recurrent: hymba decode", torch.cat(got, dim=1), want, flipped)
    step_prof = step_profile(lambda: T.decode_step(
        params, cfg, toks[:, -1:], caches,
        torch.full((1, 1), n_dec, dtype=torch.int32, device=device)))
    del caches, got, want, fwd_codes, route_codes
    lap("decode")

    soft_cfg, soft = softmax_twin(params, cfg)
    reset_launches()
    with attention_census() as soft_census:
        t0 = time.perf_counter()
        logits, _ = T.forward(soft, soft_cfg, tokens)
        sync(device)
        soft_s = time.perf_counter() - t0
    soft_launches = launch_counters()[1]()
    soft_streamed = L if n > attention.STREAM_THRESHOLD else 0
    if (soft_census["streaming"] != soft_streamed or soft_census["gated_attention"]
            or any(soft_launches.values())):
        raise AssertionError(f"recurrent: hymba softmax forward took routes {soft_census} and "
                             f"launched {soft_launches} (expected {soft_streamed} streamed)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("recurrent: hymba softmax logits are not finite")
    lap("softmax_forward")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del logits, soft, params
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, global_layers=n_global, d_model=cfg.d_model,
                heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=dh, d_state=cfg.ssm.d_state,
                vocab=cfg.vocab, params=param_bytes // 4, param_bytes=param_bytes, tokens=n,
                init_params_s=laps["init"], first_forward_s=forward_s, ms_per_forward=ms,
                tokens_per_s=n / (ms / 1e3),
                launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                attention_routes=census, profile=dict(
                    device_busy_ms=prof["device_busy_ms"],
                    wall_ms_profiled=prof["wall_ms_profiled"],
                    device_idle_share=prof["device_idle_share"], kernels=prof["kernels"],
                    top_kernels=prof["top_kernels"]),
                layer0_scan=dict(scan, scan_ms_all_layers_share_of_forward=(
                    L * scan["chunked_scan_ms"] / ms)),
                decode=dict(steps=n_dec, seconds_with_codes_recorded=decode_s,
                            ms_per_step=decode_s / n_dec * 1e3, step_profile=step_prof, **dec),
                softmax=dict(seconds=soft_s, attention_routes=soft_census),
                mem_gb=dict(start=start_gb, peak=peak), step_seconds=laps)


def hymba_ring_phase(cfg=None, n_dec: int = 1100, device=None) -> dict:
    """hymba-1.5b with VQT at full width, depth cut to two layers (one
    global, one local with its 1,024-token window): ``decode_step`` over
    n_dec tokens, past the local layer's ring, the last step's logits
    within 2e-3 of a [1, n_dec] forward unless its own code flipped at a
    near tie."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    device = torch.device(device or DEVICE)
    if cfg is None:
        full = get_config("hymba-1.5b", vqt=True)
        glob, local = full.stages[0][0][0], full.stages[1][0][0]
        cfg = dataclasses.replace(full, n_layers=2,
                                  stages=(((glob,), 1), ((local,), 1))).validate()
    L = n_layers(cfg)
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    toks = torch.randint(0, cfg.vocab, (1, n_dec), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    with recorded_codes() as fwd_codes:
        want = T.forward(params, cfg, toks)[0][:, -1:]
    launches = launch_counters()[1]()
    caches = T.init_caches(cfg, 1, n_dec, device=device)
    ring = [c["mix"]["attn"]["k"].shape[2] for st in caches for c in st]
    sync(device)
    t0 = time.perf_counter()
    with recorded_codes() as route_codes:
        for i in range(n_dec):
            step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                         torch.full((1, 1), i, dtype=torch.int32, device=device))
    sync(device)
    decode_s = time.perf_counter() - t0
    flipped = code_flips(fwd_codes, route_codes, L, "recurrent: hymba ring decode")
    dec = rows_close("recurrent: hymba ring decode", step, want,
                     None if flipped is None else flipped[:, -1:])
    del params, caches, fwd_codes, route_codes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, windows=[layer.window for layer in cfg.layer_list()],
                reduced="depth 32 -> 2: one global, one local layer", cache_slots=ring,
                forward_launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                decode=dict(steps=n_dec, seconds_with_codes_recorded=decode_s,
                            ms_per_step=decode_s / n_dec * 1e3, **dec))


# ---------------------------------------------------------- MLA and MoE

ROUTE_TIE = 1e-5  # k-th and (k+1)-th router probabilities this close may swap


@contextlib.contextmanager
def recorded_routes():
    """Record every ``models.moe._router`` call while the block runs: its
    expert ids sorted per token [T, k] and, per token, the gap between the
    k-th and (k+1)-th router probabilities [T]. Yields the list of (ids,
    gap) pairs in call order."""
    from repro_torch.models import moe

    calls = []
    router = moe._router

    def rec(params, e, x):
        gates, eidx, aux = router(params, e, x)
        probs = torch.softmax(x.to(torch.float32) @ params["router"], dim=-1)
        top = probs.topk(min(e.top_k + 1, e.n_experts), dim=-1).values
        gap = (top[:, e.top_k - 1] - top[:, e.top_k] if e.top_k < e.n_experts
               else torch.full_like(top[:, 0], float("inf")))
        calls.append((eidx.sort(-1).values, gap))
        return gates, eidx, aux

    with mock.patch.object(moe, "_router", rec):
        yield calls


@contextlib.contextmanager
def vq_census():
    """Count ``core.vq``'s ``vq_assign`` calls by "NxDV" (tokens x a VQ
    head's width) while the block runs. Yields the dict that fills."""
    from repro_torch.core import vq as vq_mod

    census: dict[str, int] = {}
    call = vq_mod.vq_assign

    def counted(x, codebook):
        key = f"{x.numel() // x.shape[-1]}x{codebook.shape[-1]}"
        census[key] = census.get(key, 0) + 1
        return call(x, codebook)

    with mock.patch.object(vq_mod, "vq_assign", counted):
        yield census


def route_flips(fwd: list, route: list, L: int, what: str, index=None) -> torch.Tensor:
    """The router's picks in a forward (``fwd``: one call an MoE layer over
    all [b·n] tokens) against another route over the same tokens
    (``route``: one call an MoE layer a decode step, tokens in order; or,
    with ``index`` [T], one call a layer whose token t is row ``index[t]``,
    as ``moe_per_code``'s codebook rows). A token whose experts differ in
    any layer must sit at a near tie (its k-th and (k+1)-th probabilities
    within ROUTE_TIE in either route), else this raises. Returns the [T]
    tokens whose picks differ."""
    f_ids, f_gap = (torch.stack([c[i] for c in fwd]) for i in (0, 1))  # [L, T, k], [L, T]
    if index is None:
        r_ids = torch.stack([torch.cat([c[0] for c in route[li::L]]) for li in range(L)])
        r_gap = torch.stack([torch.cat([c[1] for c in route[li::L]]) for li in range(L)])
    else:
        r_ids = torch.stack([c[0][index] for c in route])
        r_gap = torch.stack([c[1][index] for c in route])
    differ = (f_ids != r_ids).any(-1)  # [L, T]
    near = (f_gap <= ROUTE_TIE) | (r_gap <= ROUTE_TIE)
    if bool((differ & ~near).any()):
        raise AssertionError(f"{what}: router picks differ away from a near tie")
    return differ.any(0)


def route_ties(calls: list) -> int:
    """Tokens at a routing near tie, summed over the recorded calls."""
    return int(sum(int((gap <= ROUTE_TIE).sum()) for _, gap in calls))


def moe_loop_form(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The reference's dense MoE loop (``repro/models/moe.py:82-93``):
    every expert on every token, weighted by its gate (0 where the token
    did not route to it), in expert order, then the shared experts."""
    from repro_torch.models import moe
    from repro_torch.models.ffn import ffn_apply

    e = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    gates, eidx, _ = moe._router(params, e, xt)
    y = torch.zeros_like(xt)
    for i in range(e.n_experts):
        wi = ((eidx == i).to(x.dtype) * gates.to(x.dtype)).sum(-1, keepdim=True)
        y = y + moe._expert_ffn(params, i, xt) * wi
    if "shared" in params:
        y = y + ffn_apply("swiglu", params["shared"], xt)
    return y.reshape(x.shape)


def deepseek_cut(name: str, dense: int, moe_layers: int):
    """``name``'s full-width config with VQT, depth cut to ``dense`` dense
    layers then ``moe_layers`` MoE layers (the published first-k-dense
    layout, shortened)."""
    from repro_torch.configs import get_config

    full = get_config(name, vqt=True)
    first, moe_layer = full.stages[0][0][0], full.stages[1][0][0]
    return dataclasses.replace(full, n_layers=dense + moe_layers, stages=(
        ((first,), dense), ((moe_layer,), moe_layers))).validate()


def mla_stream_check(params: dict, cfg, tokens: torch.Tensor, device) -> dict:
    """Layer 0's MLA attention output (before VQ and ``wo``) on ``tokens``
    through ``streaming_attention`` and through the dense scores (forced by
    raising ``STREAM_THRESHOLD`` past n), within 2e-5
    (``tests/test_models.py:130-133``)."""
    from repro_torch.models import attention, mla
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_tokens
    from repro_torch.models.norms import apply_norm

    n = tokens.shape[1]
    lp = T._index(params["stages"][0], 0)[0]
    pos = torch.arange(n, dtype=torch.int32, device=device)[None]
    h = apply_norm(cfg.norm, lp["norm1"], embed_tokens(params["embed"], cfg, tokens, pos))
    layer = cfg.layer_list()[0]
    with mock.patch.object(mla, "_project_out", lambda p, o: o):
        stream, _ = mla.mla_apply(lp["mixer"], cfg, layer, h, pos)
        with mock.patch.object(attention, "STREAM_THRESHOLD", n):
            dense, _ = mla.mla_apply(lp["mixer"], cfg, layer, h, pos)
    err = float((stream - dense).abs().max())
    if not torch.allclose(stream, dense, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"moe: {cfg.name} layer 0 MLA streaming differs from the dense "
                             f"scores by {err} (atol = rtol = 2e-5)")
    return dict(tokens=n, streaming_vs_dense_max_abs_err=err,
                dense_scores_gb=cfg.n_heads * n * n * 4 / 1e9)


def moe_layer_checks(params: dict, cfg, tokens: torch.Tensor, n_moe: int, per_code: tuple,
                     device) -> dict:
    """MoE layer 1 (the first MoE layer) on the first ``n_moe`` tokens'
    hidden states: the routed dispatch against ``moe_loop_form`` within
    atol = rtol = 2e-5 (``tests/test_models.py:192-194``), both timed; then
    ``moe_per_code`` on a ``Compressed`` of ``per_code`` = (rows, b, n)
    random rows and indices against the dense MoE on ``to_dense()`` within
    2e-5, tokens at a routing near tie exempt and counted, both timed. One
    routed call is profiled: its device launches (the dispatch's host
    launches, about 8 an expert with tokens) and idle share."""
    from repro_torch.core.compressed import from_dense_rows
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed_tokens
    from repro_torch.models.mla import mla_apply
    from repro_torch.models.norms import apply_norm

    layers = cfg.layer_list()
    li = next(i for i, layer in enumerate(layers) if layer.ffn == "moe")
    flat = [lp for (pattern, repeat), sp in zip(cfg.stages, params["stages"])
            for r in range(repeat) for lp in T._index(sp, r)]
    toks = tokens[:, :n_moe]
    pos = torch.arange(n_moe, dtype=torch.int32, device=device)[None]
    x = embed_tokens(params["embed"], cfg, toks, pos)
    for i in range(li):
        x, _ = T._layer_fwd(flat[i], cfg, layers[i], x, pos)
    lp = flat[li]
    x = x + mla_apply(lp["mixer"], cfg, layers[li], apply_norm(cfg.norm, lp["norm1"], x), pos)[0]
    h2 = apply_norm(cfg.norm, lp["norm2"], x)
    routed, _ = moe.moe_apply_dense(lp["ffn"], cfg, h2)
    loop = moe_loop_form(lp["ffn"], cfg, h2)
    err = float((routed - loop).abs().max())
    if not torch.allclose(routed, loop, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"moe: {cfg.name} layer {li} routed dispatch differs from the "
                             f"loop form by {err} (atol = rtol = 2e-5)")
    routed_call = lambda: moe.moe_apply_dense(lp["ffn"], cfg, h2)  # noqa: E731
    prof = profiled(routed_call, (), top=3)
    out = dict(layer=li, tokens=n_moe, routed_vs_loop_max_abs_err=err,
               routed_ms=time_ms(routed_call, warmup=1, iters=3),
               loop_ms=time_ms(lambda: moe_loop_form(lp["ffn"], cfg, h2), warmup=1, iters=3),
               experts_with_tokens=int(moe._router(lp["ffn"], cfg.moe, h2.reshape(
                   -1, cfg.d_model))[1].unique().numel()),
               routed_profile={k: prof[k] for k in ("wall_ms_profiled", "device_busy_ms",
                                                    "device_idle_share", "device_launches")})
    del routed, loop

    q, b, n = per_code
    gen = torch.Generator(device=device).manual_seed(2)
    c = from_dense_rows(torch.randn((q, cfg.d_model), generator=gen, device=device),
                        torch.randint(0, q, (b, n), generator=gen, device=device))
    with recorded_routes() as code_routes:
        y_c, _ = moe.moe_per_code(lp["ffn"], cfg, c)
    with recorded_routes() as dense_routes:
        y_d, _ = moe.moe_apply_dense(lp["ffn"], cfg, c.to_dense())
    flipped = route_flips(dense_routes, code_routes, 1, f"moe: {cfg.name} moe_per_code",
                          index=c.idx.reshape(-1).long()).reshape(b, n)
    got, want = y_c.to_dense(), y_d
    bad = ((got - want).abs() > 2e-5 + 2e-5 * want.abs()).any(-1) & ~flipped
    if bool(bad.any()) or y_c.codebook.shape[0] != q:
        raise AssertionError(f"moe: {cfg.name} moe_per_code differs from the dense MoE by "
                             f"{float((got - want).abs().max())} (atol = rtol = 2e-5) or "
                             f"kept {y_c.codebook.shape[0]} rows")
    out["per_code"] = dict(
        rows=q, index=[b, n], kept_rows=y_c.codebook.shape[0],
        max_abs_err=float((got - want).abs()[~flipped].max()),
        route_near_ties=route_ties(dense_routes), route_flips=int(flipped.sum()),
        per_code_ms=time_ms(lambda: moe.moe_per_code(lp["ffn"], cfg, c), warmup=1, iters=3),
        dense_ms=time_ms(lambda: moe.moe_apply_dense(lp["ffn"], cfg, c.to_dense()),
                         warmup=1, iters=3))
    return out


def decode_check(params: dict, cfg, tokens: torch.Tensor, n_dec: int, what: str,
                 device) -> dict:
    """``decode_step`` over the first n_dec tokens from empty caches (one
    slot more, for one more step under the profiler), the last step's logits
    within 2e-3 of a [1, n_dec] forward (``tests/test_models.py:85-89``)
    unless the last token's own VQ code flipped at a near tie or its
    routing did (both counted); every step's gap is reported."""
    from repro_torch.models import transformer as T

    L = n_layers(cfg)
    L_moe = sum(layer.ffn == "moe" for layer in cfg.layer_list())
    toks = tokens[:, :n_dec]
    with recorded_codes() as fwd_codes, recorded_routes() as fwd_routes:
        want = T.forward(params, cfg, toks)[0]
    caches = T.init_caches(cfg, 1, n_dec + 1, device=device)
    got = []
    sync(device)
    t0 = time.perf_counter()
    with recorded_codes() as step_codes, recorded_routes() as step_routes:
        for i in range(n_dec):
            step, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                         torch.full((1, 1), i, dtype=torch.int32, device=device))
            got.append(step)
    sync(device)
    decode_s = time.perf_counter() - t0
    got = torch.cat(got, dim=1)
    code_flipped = code_flips(fwd_codes, step_codes, L, what)
    routed_flipped = route_flips(fwd_routes, step_routes, L_moe, what)[None]  # [1, n_dec]
    flipped = routed_flipped if code_flipped is None else code_flipped | routed_flipped
    dec = rows_close(what, got[:, -1:], want[:, -1:], flipped[:, -1:])
    dec.update(code_flip_rows=0 if code_flipped is None else int(code_flipped.sum()),
               route_flip_rows=int(routed_flipped.sum()), route_near_ties=route_ties(fwd_routes),
               max_logits_diff_by_step=[float(e) for e in (got - want).abs().amax(-1)[0]],
               max_logits_abs=float(want.abs().max()))
    step_prof = step_profile(lambda: T.decode_step(
        params, cfg, toks[:, -1:], caches,
        torch.full((1, 1), n_dec, dtype=torch.int32, device=device)))
    del caches, got, want
    return dict(steps=n_dec, seconds_with_codes_recorded=decode_s,
                ms_per_step=decode_s / n_dec * 1e3, step_profile=step_prof, **dec)


def deepseek_v2_phase(cfg=None, n: int = 4096, n_dec: int = 64, n_moe: int = 256,
                      per_code=(64, 4, 1024), device=None) -> dict:
    """deepseek-v2-236b with VQT at full width (d 5120, 128 heads with MLA
    kv_lora 512, 160 routed experts top-6 + 2 shared of 1,536, vocab
    102,400), depth cut 60 -> 3 (the dense first layer and 2 MoE layers),
    weights drawn on the card from seed 0: ``forward`` on [1, n] random
    tokens (MLA streamed past ``STREAM_THRESHOLD``, ``vq_assign`` at
    N = n, dv = 8192 once a layer, no ``gated_attention``; finite logits and
    aux loss), timed and profiled; layer 0's MLA through the streaming and
    the dense path; MoE layer 1's dispatch against the loop form and
    ``moe_per_code`` against the dense MoE (``moe_layer_checks``); n_dec
    decode steps (``decode_check``); the peak memory above the phase's
    start."""
    from repro_torch.models import transformer as T

    device = torch.device(device or DEVICE)
    on_card = device.type == "cuda"
    cfg = cfg or deepseek_cut("deepseek-v2-236b", 1, 2)
    L = n_layers(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    laps, lap = stopwatch()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    lap("init")
    param_bytes = tensor_bytes(params)  # every leaf f32
    tokens = torch.randint(0, cfg.vocab, (1, n), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    with vq_census() as census, recorded_routes() as routes:
        t0 = time.perf_counter()
        logits, aux = T.forward(params, cfg, tokens)
        sync(device)
        forward_s = time.perf_counter() - t0
    launches = launch_counters()[1]()
    dv = cfg.n_heads * cfg.mla.v_dim // cfg.vqt.n_heads
    want_vq = {f"{n}x{dv}": L}
    if census != want_vq or launches["vq_assign"] != L or launches["gated_attention"]:
        raise AssertionError(f"moe: {cfg.name} forward launched {launches} with VQ calls "
                             f"{census} (expected {want_vq}, no gated_attention)")
    if (logits.shape != (1, n, cfg.vocab) or not bool(torch.isfinite(logits).all())
            or not bool(torch.isfinite(aux["aux_loss"]))):
        raise AssertionError(f"moe: {cfg.name} forward logits or aux loss are not finite")
    aux_loss = float(aux["aux_loss"])
    experts_run = [int(ids.unique().numel()) for ids, _ in routes]
    near_ties = route_ties(routes)
    del logits, aux, routes
    call = lambda: T.forward(params, cfg, tokens)  # noqa: E731
    lap("first_forward")
    ms = time_ms(call, warmup=0, iters=2)
    lap("timed_forwards")
    prof = profiled(call, ("vq_assign", "gated_attention"), top=6)
    lap("profiled_forward")
    stream = mla_stream_check(params, cfg, tokens, device)
    lap("layer0_mla")
    moe_res = moe_layer_checks(params, cfg, tokens, n_moe, per_code, device)
    lap("moe_layer")
    dec = decode_check(params, cfg, tokens, n_dec, f"moe: {cfg.name} decode", device)
    lap("decode")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del params
    if on_card:
        torch.cuda.empty_cache()
    e = cfg.moe
    return dict(model=cfg.name, layers=L, reduced="depth 60 -> 3: the dense layer, 2 MoE layers",
                d_model=cfg.d_model, heads=cfg.n_heads, mla=dataclasses.asdict(cfg.mla),
                experts=[e.n_experts, e.top_k, e.n_shared, e.d_ff_expert], vocab=cfg.vocab,
                params=param_bytes // 4, param_bytes=param_bytes, tokens=n,
                init_params_s=laps["init"], first_forward_s=forward_s, ms_per_forward=ms,
                tokens_per_s=n / (ms / 1e3), aux_loss=aux_loss,
                launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                vq_calls=census, experts_run_per_moe_layer=experts_run,
                route_near_ties=near_ties, profile=dict(
                    device_busy_ms=prof["device_busy_ms"],
                    wall_ms_profiled=prof["wall_ms_profiled"],
                    device_idle_share=prof["device_idle_share"],
                    device_launches=prof["device_launches"], kernels=prof["kernels"],
                    top_kernels=prof["top_kernels"]),
                layer0_mla=stream, moe_layer=moe_res, decode=dec,
                mem_gb=dict(start=start_gb, peak=peak,
                            peak_above_start=None if peak is None else peak - start_gb),
                step_seconds=laps)


def deepseek_v3_phase(cfg=None, n: int = 1024, n_dec: int = 16, device=None) -> dict:
    """deepseek-v3-671b with VQT at full width (d 7168, 128 heads, 256
    routed experts top-8 + 1 shared of 2,048, vocab 129,280) and its
    multi-token prediction head, depth cut 61 -> 2 (one dense, one MoE
    layer), weights drawn on the card from seed 0: ``forward`` on [1, n]
    random tokens (finite ``logits`` and ``mtp_logits``, both [1, n,
    vocab]; ``vq_assign`` once a layer at dv = 8192), timed; n_dec decode
    steps (``decode_check``); the peak memory above the phase's start."""
    from repro_torch.models import transformer as T

    device = torch.device(device or DEVICE)
    on_card = device.type == "cuda"
    cfg = cfg or deepseek_cut("deepseek-v3-671b", 1, 1)
    L = n_layers(cfg)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9 if on_card else None
    laps, lap = stopwatch()
    params = T.init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
    sync(device)
    lap("init")
    param_bytes = tensor_bytes(params)
    tokens = torch.randint(0, cfg.vocab, (1, n), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    reset_launches()
    with vq_census() as census:
        logits, aux = T.forward(params, cfg, tokens)
    sync(device)
    launches = launch_counters()[1]()
    dv = cfg.n_heads * cfg.mla.v_dim // cfg.vqt.n_heads
    want_vq = {f"{n}x{dv}": L}
    mtp = aux.get("mtp_logits")
    if (census != want_vq or launches["vq_assign"] != L or mtp is None
            or logits.shape != (1, n, cfg.vocab) or mtp.shape != logits.shape
            or not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(mtp).all())):
        raise AssertionError(f"moe: {cfg.name} forward gave logits {tuple(logits.shape)}, mtp "
                             f"{None if mtp is None else tuple(mtp.shape)}, VQ calls {census}, "
                             f"launches {launches} (expected finite, {want_vq})")
    del logits, aux, mtp
    lap("first_forward")
    ms = time_ms(lambda: T.forward(params, cfg, tokens), warmup=0, iters=2)
    lap("timed_forwards")
    dec = decode_check(params, cfg, tokens, n_dec, f"moe: {cfg.name} decode", device)
    lap("decode")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    del params
    if on_card:
        torch.cuda.empty_cache()
    return dict(model=cfg.name, layers=L, reduced="depth 61 -> 2: one dense, one MoE layer",
                mtp=cfg.mtp, d_model=cfg.d_model, experts=[cfg.moe.n_experts, cfg.moe.top_k,
                                                           cfg.moe.n_shared, cfg.moe.d_ff_expert],
                vocab=cfg.vocab, params=param_bytes // 4, param_bytes=param_bytes, tokens=n,
                ms_per_forward=ms, tokens_per_s=n / (ms / 1e3), vq_calls=census,
                launches={k: launches[k] for k in ("gated_attention", "vq_assign")},
                decode=dec, mem_gb=dict(start=start_gb, peak=peak,
                                        peak_above_start=None if peak is None
                                        else peak - start_gb),
                step_seconds=laps)


TRAIN_TIE = 1e-5  # top-two Gumbel VQ logits this close may flip between the card and the CPU
TRAIN_LOSS_TOL = 1e-5  # the card's step loss against the CPU's, relative
TRAIN_GRAD_TOL = 1e-4  # each gradient leaf against the CPU's, relative to its max |.|
TRAIN_DRAWS = 3  # draws of Gumbel noise card_vs_cpu_step takes to find one with no flip
ULP_DRAWS = 3  # one-ulp moves of the weights whose largest reading sets a leaf's floor


@contextlib.contextmanager
def recorded_vq_train():
    """Record each training-mode VQ call (``core.vq.forward_train``, which
    the attention layers call through the module) while the block runs:
    its codes and the gap between its top two Gumbel logits, on the host.
    Yields the list of calls, in call order (a remat recompute calls again)."""
    from repro_torch.core import vq as vq_mod

    calls = []
    call = vq_mod.forward_train

    def recorded(params, x, cfg, *, noise=None, generator=None):
        out = call(params, x, cfg, noise=noise, generator=generator)
        with torch.no_grad():
            logits = vq_mod.scores(params, x) + (0.0 if noise is None else noise)
            top2 = torch.topk(logits / cfg.temperature, 2, dim=-1).values
            calls.append(dict(idx=out[1].cpu(), gap=(top2[..., 0] - top2[..., 1]).cpu()))
        return out

    with mock.patch.object(vq_mod, "forward_train", recorded):
        yield calls


def card_vs_cpu_step(cfg, b: int, n: int, seed: int = 0, device=None, grids=None) -> dict:
    """One train step's loss and gradients (``training.step.lm_loss``
    through ``value_and_grad``, remat on) on ``device`` against the same on
    the CPU through the plain versions: the same weights (drawn on the
    CPU from ``seed``), the same ``SyntheticCorpus`` batch [b, n] (sampled
    positions where the config samples them), the same Gumbel noise for
    every layer (none without VQT). VQ codes may differ only where the top
    two Gumbel logits lie within ``TRAIN_TIE`` (``first_layer_flips``), MoE
    routes only where the k-th and (k+1)-th router probabilities lie within
    ``ROUTE_TIE`` (``route_flips``). A draw of noise in which a code or a
    route flipped at a near tie is drawn again, up to ``TRAIN_DRAWS`` draws
    in all; on the first draw with no flip the loss must lie within
    ``TRAIN_LOSS_TOL`` and every gradient leaf within ``TRAIN_GRAD_TOL`` of
    its max. Raises when every draw flipped. With ``grids`` (the CPU's
    grid, the card's), each side's step runs under ``use_mesh`` of its grid,
    so a MoE layer goes through ``moe_apply_ep``: one router call a slice,
    matched slice by slice."""
    from repro_torch.common.pytree import path_names, tree_flatten_with_path
    from repro_torch.core import vq as vq_mod
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.distributed.context import use_mesh
    from repro_torch.models.transformer import init_params, params_from_numpy
    from repro_torch.training.step import lm_loss, value_and_grad

    device = device or DEVICE
    cpu = init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    card = params_from_numpy(cpu, device=torch.device(device))
    batch = next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=b, seq_len=n,
                            steps=1, pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    L = n_layers(cfg)
    n_vq = 0 if cfg.vqt is None else sum(layer.mixer != "rwkv6" for layer in cfg.layer_list())
    n_moe = sum(layer.ffn == "moe" for layer in cfg.layer_list())
    n_moe *= 1 if grids is None else grids[0].devices.size  # router calls a forward
    grids = grids or (None, None)
    _, launches = launch_counters()
    ties, flips, route_tie, route_flip = [], [], [], []
    for draw in range(TRAIN_DRAWS):
        gen = torch.Generator().manual_seed(seed + 1 + draw)
        noise = None if cfg.vqt is None else [
            vq_mod.gumbel(gen, (b, n, cfg.vqt.n_heads, cfg.vqt.codebook_size)) for _ in range(L)]
        runs = []
        for dev, params, grid in ((torch.device("cpu"), cpu, grids[0]),
                                  (torch.device(device), card, grids[1])):
            bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            reset_launches()
            sync(dev)
            t0 = time.perf_counter()
            with recorded_vq_train() as calls, recorded_routes() as routes, (
                    use_mesh(grid) if grid is not None else contextlib.nullcontext()):
                loss, _, grads = value_and_grad(
                    lm_loss, params, cfg, bt, None,
                    vq_noise=None if noise is None else [x.to(dev) for x in noise])
            sync(dev)
            runs.append(dict(loss=float(loss), grads=tree_flatten_with_path(grads),
                             calls=calls[:n_vq],  # the forward's (a remat recompute follows)
                             routes=[(i.cpu(), g.cpu()) for i, g in routes[:n_moe]],
                             seconds=time.perf_counter() - t0,
                             launches={k: v for k, v in launches().items() if v}))
        cpu_run, card_run = runs
        ties.append(sum(int(((a["gap"] <= TRAIN_TIE) | (c["gap"] <= TRAIN_TIE)).sum())
                        for a, c in zip(cpu_run["calls"], card_run["calls"])))
        flips.append(first_layer_flips(
            torch.stack([a["idx"] != c["idx"]  # [n_vq, b, n, hq], as the gaps
                         for a, c in zip(cpu_run["calls"], card_run["calls"])]),
            lambda li: (r["calls"][li]["gap"] for r in runs), TRAIN_TIE, "train step")
            if n_vq else 0)
        route_tie.append(route_ties(cpu_run["routes"] + card_run["routes"]))
        route_flip.append(int(route_flips(cpu_run["routes"], card_run["routes"], n_moe,
                                          "train step").sum()) if n_moe else 0)
        if not flips[-1] and not route_flip[-1]:
            break
    else:
        raise AssertionError(f"train step: a VQ code or a route flipped at a near tie in each "
                             f"of {TRAIN_DRAWS} draws of noise ({flips}, {route_flip} flips)")
    loss_diff = abs(card_run["loss"] - cpu_run["loss"])
    if loss_diff > TRAIN_LOSS_TOL * max(1.0, abs(cpu_run["loss"])):
        raise AssertionError(f"train step: the card's loss {card_run['loss']} differs from "
                             f"the CPU's {cpu_run['loss']} by {loss_diff}")
    grad_err = {}
    for (path, g_cpu), (_, g_card) in zip(cpu_run["grads"], card_run["grads"]):
        scale = max(float(g_cpu.abs().max()), 1e-30)
        grad_err["/".join(path_names(path))] = float((g_card.cpu() - g_cpu).abs().max()) / scale
    worst = max(grad_err, key=grad_err.get)
    if grad_err[worst] > TRAIN_GRAD_TOL:
        raise AssertionError(f"train step: gradient {worst} differs by {grad_err[worst]} "
                             f"of its max (tolerance {TRAIN_GRAD_TOL})")
    return dict(b=b, n=n, layers=L, loss_card=card_run["loss"], loss_cpu=cpu_run["loss"],
                loss_diff=loss_diff, loss_tolerance=TRAIN_LOSS_TOL,
                grad_max_rel_err=grad_err[worst], grad_worst_leaf=worst,
                grad_tolerance=TRAIN_GRAD_TOL, noise_draws=len(flips), near_ties=ties,
                near_tie_flips=flips, route_near_ties=route_tie, route_flips=route_flip,
                seconds_card=card_run["seconds"],
                seconds_cpu=cpu_run["seconds"], launches=card_run["launches"])


def train_phase(cfg=None, teacher_cfg=None, steps: int = 8, b: int = 8, n: int = 1024,
                check=(2, 256), lr: float = 6e-4, device=None) -> dict:
    """Phase 19: training. (1) ``card_vs_cpu_step`` at ``cfg``'s width cut
    to 2 layers on ``check`` = [b, n]; (2) ``cfg`` (default VQ-OPT-125M at
    full width and depth) from seed 0 through ``make_train_step`` with
    remat: ``steps`` steps at [b, n] of ``SyntheticCorpus(seed=0)`` with
    sampled positions, lr ``lr``, warmup 1 — each loss finite, the last
    below the first, 2 ``gated_attention`` launches a layer a step (the
    forward and its recompute) and one of each backward kernel; ms a step
    and tokens/s over steps 2.., peak memory; one more step profiled; (3)
    3 ``make_distill_step`` steps from the trained state with the teacher
    ``teacher_cfg`` (default OPT-125M at full width, seed 1): kl and lm
    finite; (4) ``save_pytree`` -> ``restore_pytree`` of the trained
    parameters (every leaf bitwise), and a ``BatchServer`` serving a
    256-token document from the restored file gives logits bitwise equal to
    one serving the in-memory parameters."""
    import tempfile

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs.base import uniform_stages
    from repro_torch.configs.vq_opt_125m import config
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.models.transformer import init_params, params_from_numpy
    from repro_torch.serving.batch_server import BatchServer
    from repro_torch.training import (
        make_distill_step, make_schedule, make_train_step, train_state_init,
    )
    from repro_torch.common.pytree import tree_leaves

    cfg = cfg or config()
    teacher_cfg = teacher_cfg or config(vqt=False)
    device = torch.device(device or DEVICE)
    L = n_layers(cfg)
    out = {}
    laps, lap = stopwatch()
    cut = dataclasses.replace(cfg, n_layers=2, stages=uniform_stages(cfg.layer_list()[0], 2))
    out["card_vs_cpu"] = card_vs_cpu_step(cut, *check, device=device)
    lap("card_vs_cpu")

    st = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device=device)
    out["parameters"] = sum(p.numel() for p in tree_leaves(st.params))
    step = make_train_step(cfg, make_schedule(peak_lr=lr, warmup_steps=1, total_steps=steps))
    batches = list(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=b, seq_len=n,
                              steps=steps, pos_pool=cfg.pos_pool))
    lap("init")
    _, launches = launch_counters()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    mem0 = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    reset_launches()
    losses, aux, gnorms, ms = [], [], [], []
    for batch in batches:
        sync(device)
        t0 = time.perf_counter()
        st, m = step(st, batch)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["lm_loss"]))
        aux.append(float(m["aux_loss"]))
        gnorms.append(float(m["grad_norm"]))
    counts = {k: v for k, v in launches().items() if v}
    lap("train")
    if not all(np.isfinite(losses + aux + gnorms)):
        raise AssertionError(f"train: a loss or grad norm is not finite: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    want = {"gated_attention": 2 * L * steps, "gated_attention_bwd_dkv": L * steps,
            "gated_attention_bwd_dq": L * steps}
    if counts != want:
        raise AssertionError(f"train: launches {counts}, expected {want}")
    step_ms = float(np.mean(ms[1:])) if len(ms) > 1 else ms[0]
    out["train"] = dict(
        b=b, n=n, steps=steps, lr=lr, lm_loss=losses, aux_loss=aux, grad_norm=gnorms,
        step_ms=ms, ms_per_step=step_ms, tokens_per_s=b * n / (step_ms / 1e3),
        launches=counts, launches_per_step={k: v / steps for k, v in counts.items()},
        peak_mem_gb=(torch.cuda.max_memory_allocated(device) - mem0) / 1e9
        if device.type == "cuda" else None,
        profile=profiled(lambda: step(st, batches[0]),
                         ("gated_attention_kernel", "gated_attention_bwd_dkv",
                          "gated_attention_bwd_dq"), top=8)
        if device.type == "cuda" else None)
    lap("profile")

    teacher = init_params(teacher_cfg, generator=torch.Generator().manual_seed(1), device=device)
    dstep = make_distill_step(cfg, teacher_cfg, make_schedule(peak_lr=lr, warmup_steps=1,
                                                              total_steps=3))
    ds, dm = st, []
    for batch in batches[:3]:
        ds, m = dstep(ds, teacher, batch)
        dm.append({k: float(m[k]) for k in ("loss", "kl", "lm", "aux_loss", "grad_norm")})
    if not all(np.isfinite([v for d in dm for v in d.values()])):
        raise AssertionError(f"distill: a loss is not finite: {dm}")
    out["distill"] = dm
    del ds, teacher
    lap("distill")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "student.npz")
        save_pytree(path, st.params)
        like = init_params(cfg, generator=torch.Generator().manual_seed(2), device=device)
        restored = restore_pytree(path, like)
    if not all(torch.equal(a, r) for a, r in zip(tree_leaves(st.params), tree_leaves(restored))):
        raise AssertionError("checkpoint: a restored leaf differs from the saved one")
    doc = [int(t) for t in np.random.default_rng(0).integers(0, cfg.vocab, 256)]
    logits = []
    for params in (st.params, restored):  # the server takes host weights
        srv = BatchServer(params_from_numpy(params, device="cpu"), cfg, device=device)
        srv.open_documents({"d": doc})
        logits.append(srv.logits("d"))
        del srv
    if not np.array_equal(*logits):
        raise AssertionError("checkpoint: logits served from the restored file differ")
    out["checkpoint"] = dict(leaves=len(tree_leaves(restored)), bitwise=True,
                             logits_finite=bool(np.isfinite(logits[0]).all()))
    lap("checkpoint")
    out["laps_s"] = laps
    return out


# phase 20's models: (arch, depth the full-width config is cut to, None for
# full depth). A step holds the parameters, their gradients and the old and
# new AdamW moments and parameters (28 B a parameter) plus the activations
# of the logits: phi4-mini at 32 layers (4.46 B parameters) or 16 would
# need more than the card's 80 GB; gemma3 keeps one 5-local : 1-global
# pattern (its global layer at dh = 256); hymba 8 layers (its 3 global, 5
# windowed) and rwkv6 4 layers, for the run's time (phase 23 came in);
# deepseek-v2 its dense MLA layer (an MoE layer adds 8 B parameters).
FAMILY_TRAIN = (("hymba-1.5b", 8), ("phi4-mini-3.8b", 12), ("gemma3-12b", 6),
                ("rwkv6-7b", 4), ("deepseek-v2-236b", 1))
# phase 20's card-against-CPU steps: (arch, head dim the smoke config's
# heads are widened to, None to keep them, tokens): phi4-mini's and
# gemma3's full head dims, so the card's wide backward kernels run; gemma3
# past its 64-token smoke window
FAMILY_TRAIN_CHECK = (("deepseek-v2-236b", None, 64), ("deepseek-v3-671b", None, 64),
                      ("hymba-1.5b", None, 64), ("rwkv6-7b", None, 64),
                      ("phi4-mini-3.8b", 128, 64), ("gemma3-12b", 256, 96))


@contextlib.contextmanager
def gated_attention_census():
    """Count the ``gated_attention`` forward and backward calls (a launch of
    the forward kernel, or of the dK/dV and the dQ kernel, on the card) by
    "BHxnxdh" while the block runs. Yields {"forward": {...}, "backward":
    {...}}."""
    from repro_torch.kernels.gated_attention import ops

    census = {"forward": {}, "backward": {}}
    fwd, bwd = ops._forward_bh, ops.gated_attention_bwd_bh

    def count(kind, q):
        key = "x".join(str(s) for s in q.shape)
        census[kind][key] = census[kind].get(key, 0) + 1

    def counted_fwd(q, k, v):
        count("forward", q)
        return fwd(q, k, v)

    def counted_bwd(q, k, v, do):
        count("backward", q)
        return bwd(q, k, v, do)

    with mock.patch.object(ops, "_forward_bh", counted_fwd), \
            mock.patch.object(ops, "gated_attention_bwd_bh", counted_bwd):
        yield census


def family_train_cfg(arch: str, depth: int | None):
    """``arch``'s full-width config with VQT (where it applies), its first
    stage's pattern repeated to ``depth`` layers (None: full depth;
    hymba-1.5b keeps its 3 global layers, ``hymba_cut``)."""
    from repro_torch.configs import get_config

    full = get_config(arch, vqt=True)
    if depth is None:
        return full
    if arch == "hymba-1.5b":
        return hymba_cut(3, depth - 3)
    pattern = full.stages[0][0]
    return dataclasses.replace(full, n_layers=depth,
                               stages=((pattern, depth // len(pattern)),)).validate()


def sigma_layers(cfg) -> int:
    """Layers whose attention runs ``gated_attention``: σ, no window."""
    return 0 if cfg.attn_softmax else sum(
        layer.mixer in ("gqa", "hymba") and layer.window is None for layer in cfg.layer_list())


def family_train(cfg, steps: int = 3, n: int | None = None, lr: float = 6e-4,
                 device=None) -> dict:
    """``cfg`` from seed 0 (weights drawn on ``device``'s generator) through
    ``make_train_step`` with remat: ``steps`` steps at [1, n] (default:
    ``train_4k``'s length, ``launch/specs.py``) of
    ``SyntheticCorpus(seed=0)``, lr ``lr``, warmup 1 — every loss and grad
    norm finite, every small parameter leaf moved, 2 ``gated_attention``
    launches a step a σ layer without a window (the forward and its
    recompute) and one of each backward kernel; ms a step and tokens/s over
    steps 2.., peak memory (the state included); the launches by shape; one
    more step profiled."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.training import make_schedule, make_train_step, train_state_init

    device = torch.device(device or DEVICE)
    n = n or train_4k_len()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    laps, lap = stopwatch()
    st = train_state_init(cfg, generator=torch.Generator(device=device).manual_seed(0),
                          device=device)
    leaves = tree_leaves(st.params)
    small = [i for i, p in enumerate(leaves) if p.numel() <= 1 << 16]
    before = [leaves[i].clone() for i in small]
    del leaves
    step = make_train_step(cfg, make_schedule(peak_lr=lr, warmup_steps=1, total_steps=steps))
    batches = list(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=1, seq_len=n,
                              steps=steps + 1,
                              pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    lap("init")
    _, launches = launch_counters()
    reset_launches()
    losses, aux, gnorms, ms = [], [], [], []
    with gated_attention_census() as census:
        for batch in batches[:steps]:
            sync(device)
            t0 = time.perf_counter()
            st, m = step(st, batch)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["lm_loss"]))
            aux.append(float(m["aux_loss"]))
            gnorms.append(float(m["grad_norm"]))
    counts = {k: v for k, v in launches().items() if v}
    lap("train")
    if not all(np.isfinite(losses + aux + gnorms)):
        raise AssertionError(f"{cfg.name}: a loss or grad norm is not finite: {losses} "
                             f"{aux} {gnorms}")
    leaves = tree_leaves(st.params)
    still = sum(torch.equal(leaves[i], b) for i, b in zip(small, before))
    if still:
        raise AssertionError(f"{cfg.name}: {still} of {len(small)} small leaves did not move")
    S = sigma_layers(cfg)
    want = {k: v for k, v in {"gated_attention": 2 * S * steps,
                              "gated_attention_bwd_dkv": S * steps,
                              "gated_attention_bwd_dq": S * steps}.items() if v}
    got = {k: v for k, v in counts.items() if k.startswith("gated_attention")}
    if got != want:
        raise AssertionError(f"{cfg.name}: launches {got}, expected {want}")
    step_ms = float(np.mean(ms[1:])) if len(ms) > 1 else ms[0]
    out = dict(layers=n_layers(cfg), parameters=sum(p.numel() for p in leaves), n=n,
               steps=steps, lr=lr, lm_loss=losses, aux_loss=aux, grad_norm=gnorms,
               step_ms=ms, ms_per_step=step_ms, tokens_per_s=n / (step_ms / 1e3),
               launches=counts, launches_per_step={k: v / steps for k, v in counts.items()},
               gated_attention_per_step={kind: {k: v / steps for k, v in c.items()}
                                         for kind, c in census.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None)
    del leaves
    if on_card:
        prof = profiled(lambda: step(st, batches[steps]),
                        ("gated_attention_kernel", "gated_attention_bwd"), top=8)
        out["profile"] = {k: prof[k] for k in ("wall_ms_profiled", "device_busy_ms",
                                               "device_idle_share", "device_launches",
                                               "kernels", "top_kernels")}
    lap("profile")
    out["laps_s"] = laps
    return out


def family_train_phase(models=None, checks=None, steps: int = 3, n: int | None = None,
                       check_b: int = 2, device=None) -> dict:
    """Phase 20: training of every family. (1) ``card_vs_cpu_step`` on the
    smoke configs of ``checks`` ((name, config) pairs; default
    ``FAMILY_TRAIN_CHECK``, each with VQT where it applies); (2)
    ``family_train`` on each of ``models`` ((name, config) pairs; default
    ``FAMILY_TRAIN`` at full width), each model freed before the next.
    Also sums each model's backward launches by head dim."""
    from repro_torch.configs import get_config

    device = device or DEVICE
    if checks is None:
        checks = []
        for arch, dh, cn in FAMILY_TRAIN_CHECK:
            cfg = get_config(arch, smoke=True, vqt=True)
            if dh is not None:
                cfg = dataclasses.replace(cfg, head_dim=dh)
            checks.append((f"{arch}-dh{cfg.resolved_head_dim}", cfg, cn))
    if models is None:
        models = [(arch, family_train_cfg(arch, depth)) for arch, depth in FAMILY_TRAIN]
    out = {"card_vs_cpu": {}, "models": {}, "bwd_launches_by_head_dim": {}}
    for name, cfg, cn in checks:
        out["card_vs_cpu"][name] = card_vs_cpu_step(cfg, check_b, cn, device=device)
    for name, cfg in models:
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        res = family_train(cfg, steps=steps, n=n, device=device)
        out["models"][name] = res
        dh = cfg.resolved_head_dim
        if res["launches"].get("gated_attention_bwd_dkv"):
            by_dh = out["bwd_launches_by_head_dim"]
            by_dh[dh] = by_dh.get(dh, 0) + sum(
                v for k, v in res["launches"].items() if "bwd" in k)
    return out


GRID_SHAPES = ((1, 1), (1, 4))  # (data, model) grids whose entries repeat the one card
EP_TOL = 2e-5  # EP against dense where nothing dropped (the reference's tests/test_models.py:193)
GRID_CARDS = (8, 5, 4, 2)  # a (1, k) grid of real cards: the largest k dividing 160 experts
GRID_AXES = ("data", "model")


def sync_all(device) -> None:
    """Wait for ``device`` and, on the card, for every visible card (a
    grid's copies run on the cards of its entries)."""
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def wall_ms(fn, device, warmup: int = 2, iters: int = 10) -> float:
    """Median host-clock ms of ``fn``, each run ending in ``sync_all``
    (a run over several cards, which one card's events do not cover)."""
    for _ in range(warmup):
        fn()
    sync_all(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync_all(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def ep_slices(stats: dict, M: int, T: int) -> tuple[list, torch.Tensor]:
    """The last EP call's dropped assignments a slice (data row 0) and the
    [T] tokens with a dropped assignment."""
    kept = [stats["kept"][(0, m)].cpu() for m in range(M)]
    per = [int((~k).sum()) for k in kept]
    k = kept[0].numel() // (-(-T // M))
    tokens = torch.cat([(~kk).view(-1, k).any(1) for kk in kept])[:T]
    return per, tokens


def ep_layer_check(cfg, n: int, device, grids=GRID_SHAPES, cards=None) -> dict:
    """Phase 21 (a): one MoE layer of ``cfg`` at full width (router, the
    routed experts and the shared ones drawn on ``device`` from seed 0) on
    [1, n] seeded normal tokens: ``moe_apply_ep`` on each (data, model)
    grid of ``grids`` (entries repeating ``device``) against
    ``moe_apply_dense``. With the capacity raised to E / k nothing can drop
    and EP must lie within ``EP_TOL`` of dense (a token whose route differs
    at a near tie, k-th and (k+1)-th probabilities within ``ROUTE_TIE``, is
    exempt and counted). At the config's capacity the dropped assignments a
    slice are printed and the tokens without one must lie within
    ``EP_TOL``. ms a call (CUDA events) at the config's capacity for each
    grid and dense, the bytes the exchanges copied, one profiled call each.
    With ``cards`` (a list of k devices; default: the largest k of
    ``GRID_CARDS`` when two or more cards are visible) the experts are
    placed once on a (1, k) grid of them and EP there must lie within
    ``EP_TOL`` of the one-device (1, k) grid (bitwise or not is printed),
    with the peak memory each card holds."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    device = torch.device(device)
    on_card = device.type == "cuda"
    e = cfg.moe
    laps, lap = stopwatch()
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((1, n, cfg.d_model), generator=gen, device=device)
    sync(device)
    lap("init")
    raised = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))
    out = dict(d=cfg.d_model, experts=e.n_experts, top_k=e.top_k, d_ff_expert=e.d_ff_expert,
               shared=e.n_shared, tokens=n, parameters=sum(p.numel() for p in tree_leaves(params)),
               parameter_bytes=tensor_bytes(params), capacity_factor=e.capacity_factor,
               raised_capacity_factor=raised.moe.capacity_factor, tolerance=EP_TOL, grids={})
    with torch.no_grad():
        with recorded_routes() as dense_routes:
            y_d, aux_d = moe.moe_apply_dense(params, cfg, x)
        out["dense"] = dict(aux=float(aux_d), ms=time_ms(lambda: moe.moe_apply_dense(
            params, cfg, x)))
        prof = profiled(lambda: moe.moe_apply_dense(params, cfg, x), (), top=5)
        out["dense"]["profile"] = {k: prof[k] for k in (
            "wall_ms_profiled", "device_busy_ms", "device_idle_share", "device_launches")}
        lap("dense")
        for shape in grids:
            grid = make_mesh(shape, GRID_AXES, [device] * int(np.prod(shape)))
            M = shape[1]
            res = {}
            for what, c in (("raised", raised), ("config", cfg)):
                moe.reset_ep_stats()
                with recorded_routes() as routes, use_mesh(grid):
                    y, aux = moe.moe_apply_ep(params, c, x)
                flipped = route_flips(dense_routes, routes, 1, f"grid {shape}").cpu()
                per, dropped = ep_slices(moe.EP_STATS, M, n)
                ok = (~(flipped | dropped)).to(device)
                err = float((y[0][ok] - y_d[0][ok]).abs().max())
                if what == "raised" and sum(per):
                    raise AssertionError(f"grid {shape}: {sum(per)} assignments dropped at "
                                         f"capacity factor {c.moe.capacity_factor}")
                if err > EP_TOL:
                    raise AssertionError(f"grid {shape}, {what} capacity: EP differs from "
                                         f"dense by {err} on tokens with no drop")
                res[what] = dict(capacity=moe._ep_capacity(-(-n // M), c.moe, e.n_experts),
                                 max_abs_err_vs_dense=err, route_near_tie_flips=int(flipped.sum()),
                                 dropped_per_slice=per, tokens_with_a_drop=int(dropped.sum()),
                                 aux=float(aux), exchange_bytes=moe.EP_STATS["exchange_bytes"],
                                 device_copy_bytes=moe.EP_STATS["device_copy_bytes"])
                del y
            run = lambda: moe_ep_call(moe, params, cfg, x, grid)  # noqa: E731
            res["config"]["ms"] = time_ms(run)
            prof = profiled(run, (), top=5)
            res["config"]["profile"] = {k: prof[k] for k in (
                "wall_ms_profiled", "device_busy_ms", "device_idle_share", "device_launches",
                "top_kernels")}
            out["grids"]["x".join(map(str, shape))] = res
            lap(f"grid {shape}")
        if cards is None and on_card and torch.cuda.device_count() >= 2:
            k = next(c for c in GRID_CARDS if c <= torch.cuda.device_count()
                     and e.n_experts % c == 0)
            cards = [torch.device("cuda", i) for i in range(k)]
        if cards:
            out["cards"] = placed_cards_check(moe, params, cfg, x, cards, device)
            lap("cards")
    out["laps_s"] = laps
    return out


def moe_ep_call(moe, params, cfg, x, grid):
    from repro_torch.distributed.context import use_mesh

    with use_mesh(grid):
        return moe.moe_apply_ep(params, cfg, x)


def placed_cards_check(moe, params, cfg, x, cards, device) -> dict:
    """Phase 21 (a) on k cards: the experts placed once on a (1, k) grid of
    ``cards`` (``place_experts``), EP there against EP on a (1, k) grid of
    ``device`` alone with the whole leaves (the same M): within
    ``EP_TOL``, bitwise or not; ms a call (host clock over all cards) for
    both; the peak memory each card holds."""
    from repro_torch.launch.mesh import make_mesh

    k = len(cards)
    on_card = torch.device(device).type == "cuda"
    one = make_mesh((1, k), GRID_AXES, [device] * k)
    grid = make_mesh((1, k), GRID_AXES, cards)
    y_one, _ = moe_ep_call(moe, params, cfg, x, one)
    placed = moe.place_experts(params, grid)
    if on_card:
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
    moe.reset_ep_stats()
    y, _ = moe_ep_call(moe, placed, cfg, x, grid)
    sync_all(device)
    err = float((y - y_one).abs().max())
    if err > EP_TOL:
        raise AssertionError(f"{k} cards: EP differs from one card's by {err}")
    out = dict(cards=[str(c) for c in cards], max_abs_err_vs_one_card=err,
               bitwise=bool(torch.equal(y.cpu(), y_one.cpu())),
               exchange_bytes=moe.EP_STATS["exchange_bytes"],
               device_copy_bytes=moe.EP_STATS["device_copy_bytes"],
               ms=wall_ms(lambda: moe_ep_call(moe, placed, cfg, x, grid), device),
               one_card_ms=wall_ms(lambda: moe_ep_call(moe, params, cfg, x, one), device))
    if on_card:
        out["peak_mem_gb"] = {str(c): torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
        out["resident_gb"] = {str(c): torch.cuda.memory_allocated(c) / 1e9 for c in cards}
    del placed
    return out


def grid_train_check(cfg, b: int, n: int, device) -> dict:
    """Phase 21 (b): one train step of ``cfg`` (deepseek-v2's smoke config)
    under a (2, 2) grid of the card's entries against the same step under
    a (2, 2) grid of the CPU (``card_vs_cpu_step``: loss within 1e-5, every
    gradient leaf within 1e-4 of its max), the same on (1, 1) grids; then
    ``launch.train``'s ``--mesh host`` step function on the card (its MoE
    layers through ``moe_apply_ep``) against ``make_train_step`` under a
    (1, 1) grid of the card: the same loss, bitwise."""
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.training import make_schedule, make_train_step, train_state_init

    out = {}
    for shape in ((2, 2), (1, 1)):
        grids = tuple(make_mesh(shape, GRID_AXES, [dev] * int(np.prod(shape)))
                      for dev in ("cpu", device))
        out["x".join(map(str, shape))] = card_vs_cpu_step(cfg, b, n, device=device, grids=grids)
    sched = make_schedule(peak_lr=1e-3, warmup_steps=1, total_steps=2)
    batch = next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=b, seq_len=n,
                            steps=1, pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    state = lambda: train_state_init(cfg, generator=torch.Generator().manual_seed(0),  # noqa: E731
                                     device=device)
    launcher = launch_train.grid_step(make_train_step(cfg, sched),
                                      launch_train.make_grid("host", device))
    moe.reset_ep_stats()
    _, m_launch = launcher(state(), batch)
    ep_calls = moe.EP_STATS["calls"]
    with use_mesh(make_mesh((1, 1), GRID_AXES, [device])):
        _, m_grid = make_train_step(cfg, sched)(state(), batch)
    n_moe = sum(layer.ffn == "moe" for layer in cfg.layer_list())
    if ep_calls < n_moe:
        raise AssertionError(f"launch.train --mesh host: {ep_calls} moe_apply_ep calls for "
                             f"{n_moe} MoE layers")
    if float(m_launch["lm_loss"]) != float(m_grid["lm_loss"]):
        raise AssertionError(f"launch.train --mesh host: loss {float(m_launch['lm_loss'])}, "
                             f"under a 1x1 grid {float(m_grid['lm_loss'])}")
    out["launcher_host"] = dict(ep_calls=ep_calls, moe_layers=n_moe,
                                lm_loss=float(m_launch["lm_loss"]),
                                aux_loss=float(m_launch["aux_loss"]), bitwise=True)
    return out


def grid_phase(cfg=None, n: int = 1024, train_cfg=None, train_b: int = 2, train_n: int = 64,
               grids=GRID_SHAPES, cards=None, device=None) -> dict:
    """Phase 21: the model axis and the expert-parallel MoE. (a)
    ``ep_layer_check`` on ``cfg`` (default deepseek-v2-236b's MoE layer at
    full width: 160 experts top-6 at d 5120, f 1536, 2 shared) over
    ``grids``; (b) ``grid_train_check`` on ``train_cfg`` (default
    deepseek-v2's smoke config with VQT) at [train_b, train_n]."""
    from repro_torch.configs import get_config

    device = device or DEVICE
    cfg = cfg or get_config("deepseek-v2-236b")
    train_cfg = train_cfg or get_config("deepseek-v2-236b", smoke=True, vqt=True)
    out = dict(routed_layer=ep_layer_check(cfg, n, device, grids=grids, cards=cards))
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = grid_train_check(train_cfg, train_b, train_n, device)
    return out


SHARDED_GRIDS = ((2, 2), (1, 4))  # phase 22 (a): (data, model) grids whose entries repeat the card
SHARDED_PHI4 = (4, 2048, (1, 2))  # phase 22 (b): phi4-mini's layers, tokens and grid
SHARDED_CARDS = (4, 2)  # phase 22 (c): the most cards of a (1, k) grid across cards


def grid_of(shape, devices) -> object:
    """A (data, model) grid of ``shape`` over ``devices`` (one device
    repeated, or one card an entry)."""
    from repro_torch.launch.mesh import make_mesh

    k = int(np.prod(shape))
    devices = list(devices)
    return make_mesh(shape, GRID_AXES, devices if len(devices) >= k else devices[:1] * k)


def grid_grads(params, cfg, batch: dict, noise, grid, placed: bool) -> dict:
    """``lm_loss`` and its gradients under ``grid`` with the given noise:
    the parameters placed by the plan (``place``; the gradients reduced
    over the replicas and assembled) or laid out in the forward; the VQ
    calls' codes and top-two gaps a layer (rows joined); seconds; the
    kernels' launches; the collectives' bytes by kind."""
    from repro_torch.distributed.context import (
        GRID_STATS, grid_index_rows, reduce_replicas, reset_grid_stats, use_mesh,
    )
    from repro_torch.launch.sharding import place, unplace
    from repro_torch.training.step import lm_loss, value_and_grad

    D = len(grid_index_rows(grid))
    dev = torch.device(grid.devices.flat[0])
    _, launches = launch_counters()
    reset_launches()
    reset_grid_stats()
    sync_all(dev)
    t0 = time.perf_counter()
    with use_mesh(grid), recorded_vq_train() as calls:
        p = place(params, grid) if placed else params
        loss, _, grads = value_and_grad(lm_loss, p, cfg, batch, None, vq_noise=noise)
        if placed:
            grads = unplace(reduce_replicas(grads))
    sync_all(dev)
    seconds = time.perf_counter() - t0
    L = n_layers(cfg) if cfg.vqt is not None else 0
    fwd = calls[:L * D]  # the forward's (the recompute's follow)
    codes = [(torch.cat([c["idx"] for c in fwd[li * D:(li + 1) * D]]),
              torch.cat([c["gap"] for c in fwd[li * D:(li + 1) * D]])) for li in range(L)]
    return dict(loss=float(loss), grads=grads, codes=codes, seconds=seconds,
                launches={k: v for k, v in launches().items() if v},
                collective_bytes=dict(GRID_STATS["bytes"]),
                device_bytes=dict(GRID_STATS["device_bytes"]))


def sharded_check(params, cfg, b: int, n: int, grids: dict, device, placed=True,
                  seed: int = 0, ulp_floor: bool = False) -> dict:
    """One train step's loss and gradients of ``cfg`` at [b, n] under each
    of ``grids`` ({name: grid}) against the 1x1 grid of ``device``, with
    the same Gumbel noise (drawn for the whole batch, sliced to the rows):
    the loss within ``TRAIN_LOSS_TOL``, every gradient leaf within
    ``TRAIN_GRAD_TOL`` of its max. A VQ code that differs at a near tie
    (top two Gumbel logits within ``TRAIN_TIE``, ``first_layer_flips``)
    redraws the noise, up to ``TRAIN_DRAWS`` draws. With ``ulp_floor`` the
    1x1 step is also run on the weights each moved by one part in 2^24
    (``ulp_sensitivity``, with the same noise and no VQ code moved), and
    each leaf's gate is the larger of ``TRAIN_GRAD_TOL`` and twice the most
    that one of ``ULP_DRAWS`` such moves did to the leaf: no order of the
    float sums can hold the grid nearer than the 1x1 step's own rounding
    moves it, and one move's reading of a leaf varies from draw to draw
    (``tools/grad_floor.py``)."""
    from repro_torch.common.pytree import path_names, tree_flatten_with_path
    from repro_torch.core import vq as vq_mod
    from repro_torch.data import SyntheticCorpus, lm_batches

    device = torch.device(device)
    batch = next(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=b, seq_len=n,
                            steps=1, pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    one = grid_of((1, 1), [device])
    L = n_layers(cfg)
    grid_grads(params, cfg, batch, None, one, placed=False)  # warm: cuBLAS's first calls
    flips = []
    for draw in range(TRAIN_DRAWS):
        gen = torch.Generator(device=device).manual_seed(seed + 1 + draw)
        noise = None if cfg.vqt is None else [
            vq_mod.gumbel(gen, (b, n, cfg.vqt.n_heads, cfg.vqt.codebook_size)) for _ in range(L)]
        base = grid_grads(params, cfg, batch, noise, one, placed=False)
        runs = {name: grid_grads(params, cfg, batch, noise, g, placed)
                for name, g in grids.items()}
        flips.append({name: first_layer_flips(
            torch.stack([a[0] != c[0] for a, c in zip(base["codes"], r["codes"])]),
            lambda li, r=r: (base["codes"][li][1], r["codes"][li][1]), TRAIN_TIE,
            f"sharded step {name}") if r["codes"] else 0 for name, r in runs.items()})
        if not any(flips[-1].values()):
            break
        del runs
    else:
        raise AssertionError(f"sharded step: a VQ code flipped at a near tie in each of "
                             f"{TRAIN_DRAWS} draws ({flips})")
    out = {"b": b, "n": n, "layers": L, "loss_1x1": base["loss"], "seconds_1x1": base["seconds"],
           "launches_1x1": base["launches"], "noise_draws": len(flips),
           "near_tie_flips": flips, "grids": {}}
    want = dict(tree_flatten_with_path(base["grads"]))
    floor = ulp_sensitivity(params, cfg, batch, noise, one, base) if ulp_floor else {}
    tol = {}
    for path in want:
        leaf = "/".join(path_names(path))
        tol[leaf] = max([TRAIN_GRAD_TOL] + [2 * v for v in floor.get(leaf, [])])
    if ulp_floor:
        out["ulp_floor"] = floor
    for name, r in runs.items():
        diff = abs(r["loss"] - base["loss"])
        if diff > TRAIN_LOSS_TOL * max(1.0, abs(base["loss"])):
            raise AssertionError(f"sharded step {name}: loss {r['loss']} against the 1x1 "
                                 f"grid's {base['loss']}")
        err = {}
        for path, g in tree_flatten_with_path(r["grads"]):
            w = want[path]
            err["/".join(path_names(path))] = float((g - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
        worst = max(err, key=lambda leaf: err[leaf] / tol[leaf])
        if err[worst] > tol[worst]:
            raise AssertionError(f"sharded step {name}: gradient {worst} differs by "
                                 f"{err[worst]} of its max (tolerance {tol[worst]})")
        out["grids"][name] = dict(loss=r["loss"], loss_diff=diff,
                                  grad_max_rel_err=max(err.values()), grad_worst_leaf=worst,
                                  grad_tol=tol[worst], grad_err=err if ulp_floor else None,
                                  seconds=r["seconds"],
                                  launches=r["launches"], collective_bytes=r["collective_bytes"],
                                  device_bytes=r["device_bytes"])
    return out


def ulp_sensitivity(params, cfg, batch: dict, noise, grid, base: dict) -> dict:
    """{leaf: [how far the gradients of ``params`` with every weight moved
    by one part in 2^24 (a seeded random sign each) lie from ``base``'s
    (``grid_grads`` of the unmoved weights with ``noise``), relative to the
    leaf's max, for each of ``ULP_DRAWS`` moves]}. A move that changes a VQ
    code is skipped; more than ``TRAIN_DRAWS`` skips fail."""
    from repro_torch.common.pytree import path_names, tree_flatten_with_path, tree_map_with_path

    want = dict(tree_flatten_with_path(base["grads"]))
    out: dict = {}
    for seed in range(1, ULP_DRAWS + TRAIN_DRAWS + 1):
        gen = torch.Generator(device=torch.device(grid.devices.flat[0])).manual_seed(seed)

        def moved(_path, x):
            sign = torch.randint(0, 2, x.shape, generator=gen, device=x.device) * 2 - 1
            return x * (1 + sign * 2.0 ** -24)

        got = grid_grads(tree_map_with_path(moved, params), cfg, batch, noise, grid,
                         placed=False)
        if not all(torch.equal(a[0], c[0]) for a, c in zip(base["codes"], got["codes"])):
            continue
        for path, g in tree_flatten_with_path(got["grads"]):
            out.setdefault("/".join(path_names(path)), []).append(
                float((g - want[path]).abs().max()) / max(float(want[path].abs().max()), 1e-30))
        if len(next(iter(out.values()))) == ULP_DRAWS:
            return out
    raise AssertionError(f"ulp_sensitivity: a VQ code moved in more than {TRAIN_DRAWS} draws")


def sharded_state_steps(cfg, b: int, n: int, grids: dict, share=False) -> dict:
    """The train step on a state drawn on the CPU from seed 0 and placed on
    each of ``grids`` (each card receives its blocks): every replica of
    every leaf (one copy an entry with ``share=False``, as on distinct
    cards) bitwise equal after the update; ms a step (host clock over the
    grid's cards, the second of two steps), the launches a step, the
    collectives' bytes by kind, each card's resident and peak bytes."""
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.distributed.context import GRID_STATS, reset_grid_stats, use_mesh
    from repro_torch.launch.sharding import place_state
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.training import make_schedule, make_train_step, train_state_init

    batches = list(lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=b, seq_len=n,
                              steps=2, pos_pool=cfg.pos_pool if cfg.pos == "sampled" else None))
    step = make_train_step(cfg, make_schedule(peak_lr=6e-4, warmup_steps=1, total_steps=2))
    _, launches = launch_counters()
    host = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for name, grid in grids.items():
        device = torch.device(grid.devices.flat[0])
        on_card = device.type == "cuda"
        cards = sorted({str(d) for d in grid.devices.flat})
        state = place_state(host, grid, share=share)
        gc.collect()
        if on_card:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
        resident = {c: torch.cuda.memory_allocated(c) / 1e9 for c in cards} if on_card else None
        with use_mesh(grid):
            state, m0 = step(state, batches[0])
            sync_all(device)
            reset_launches()
            reset_grid_stats()
            t0 = time.perf_counter()
            state, m1 = step(state, batches[1])
            sync_all(device)
            ms = (time.perf_counter() - t0) * 1e3
        losses = [float(m0["lm_loss"]), float(m1["lm_loss"])]
        if not np.isfinite(losses).all():
            raise AssertionError(f"sharded steps {name}: a loss is not finite: {losses}")
        replicas = unequal = 0
        for tree in (state.params, state.opt.mu, state.opt.nu):
            for leaf in tree_leaves(tree):
                for held in leaf.replicas():
                    replicas += len(held) - 1
                    first = held[0][1]
                    unequal += sum(not torch.equal(first, t.to(first.device))
                                   for _, t in held[1:])
        if unequal:
            raise AssertionError(f"sharded steps {name}: {unequal} of {replicas} replicas "
                                 "differ after the update")
        out[name] = dict(cards=cards, lm_loss=losses, ms_step=ms,
                         launches_per_step={k: v for k, v in launches().items() if v},
                         collective_bytes=dict(GRID_STATS["bytes"]),
                         device_bytes=dict(GRID_STATS["device_bytes"]),
                         replicas_checked=replicas, replicas_bitwise=True,
                         resident_gb=resident,
                         peak_gb={c: torch.cuda.max_memory_allocated(c) / 1e9 for c in cards}
                         if on_card else None)
        del state
    return out


def deepseek_cards_steps(cfg, n: int, cards: list, steps: int = 2) -> dict:
    """Phase 22 (d): ``cfg`` (deepseek-v2 at full width, its dense layer
    and one MoE layer, VQT) trained on a (1, k) grid of ``cards``: the
    parameters drawn on the first card's generator, placed by the plan
    and the whole leaves freed, the AdamW moments made on each card's
    blocks; ``steps`` steps at [1, n]: every loss finite; ms a step (host
    clock over the cards), each card's resident and peak bytes, the bytes
    that crossed cards a step."""
    from repro_torch.common.pytree import tensor_leaves, tree_leaves
    from repro_torch.data import SyntheticCorpus, lm_batches
    from repro_torch.distributed.context import GRID_STATS, reset_grid_stats, use_mesh
    from repro_torch.launch.sharding import place
    from repro_torch.models.transformer import init_params
    from repro_torch.training import make_schedule, make_train_step
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.step import TrainState

    grid = grid_of((1, len(cards)), cards)
    names = [str(c) for c in cards]
    on_card = cards[0].type == "cuda"
    whole = init_params(cfg, generator=torch.Generator(device=cards[0]).manual_seed(0),
                        device=cards[0])
    params = place(whole, grid)
    del whole
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    state = TrainState(params=params, opt=adamw_init(params),
                       rng=torch.tensor([0, 0], dtype=torch.int64))
    n_params = sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(params))
    resident = {c: torch.cuda.memory_allocated(c) / 1e9 for c in names} if on_card else None
    if on_card:
        for c in names:
            torch.cuda.reset_peak_memory_stats(c)
    step = make_train_step(cfg, make_schedule(peak_lr=6e-4, warmup_steps=1, total_steps=steps))
    batches = lm_batches(SyntheticCorpus(vocab=cfg.vocab, seed=0), batch=1, seq_len=n,
                         steps=steps)
    losses, ms, crossed = [], [], []
    with use_mesh(grid):
        for batch in batches:
            reset_grid_stats()
            sync_all(cards[0])
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync_all(cards[0])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["lm_loss"]))
            crossed.append(dict(GRID_STATS["device_bytes"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name} on {len(cards)} cards: a loss is not finite: {losses}")
    out = dict(layers=n_layers(cfg), parameters=n_params, n=n, lm_loss=losses, step_ms=ms,
               resident_gb=resident,
               peak_gb={c: torch.cuda.max_memory_allocated(c) / 1e9 for c in names}
               if on_card else None,
               bytes_across_cards=crossed[-1],
               tensors_a_card={c: sum(t.device == torch.device(c)
                                      for t in tensor_leaves(state.params)) for c in names})
    del state
    return out


def sharded_phase(cfg=None, b: int = 8, n: int = 1024, phi4=SHARDED_PHI4, grids=SHARDED_GRIDS,
                  device=None) -> dict:
    """Phase 22: the train step run by the sharding plan across a grid.
    (a) ``cfg`` (default VQ-OPT-125M at full width and depth, weights from
    seed 0 on the CPU) at [b, n], remat on: ``sharded_check`` under each
    of ``grids`` (entries repeating the card, the parameters placed)
    against the 1x1 grid, then ``sharded_state_steps`` (one copy an entry:
    the replicas bitwise after the update). (b) phi4-mini-3.8B VQT at full
    width cut to ``phi4[0]`` layers (weights on the card's generator) at
    [1, phi4[1]]: ``sharded_check`` under a ``phi4[2]`` grid of the card,
    laid out in the forward (GQA 24 : 8 and dh 128 a block). (c) with two
    or more cards, VQ-OPT's placed steps on a (1, k) grid of k cards
    against (a)'s one-card numbers: resident bytes a card, bytes across
    cards. (d) deepseek-v2 at full width, 2 layers, on a (1, 4) grid of
    cards: with four cards only."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs.vq_opt_125m import config
    from repro_torch.models.transformer import init_params

    device = torch.device(device or DEVICE)
    cfg = cfg or config()
    laps, lap = stopwatch()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device=device)
    named = {"x".join(map(str, s)): grid_of(s, [device]) for s in grids}
    out = {"vq_opt": sharded_check(params, cfg, b, n, named, device)}
    del params
    lap("a_check")
    out["vq_opt_steps"] = sharded_state_steps(cfg, b, n, named)
    lap("a_steps")
    layers, pn, pshape = phi4
    pcfg = family_train_cfg("phi4-mini-3.8b", layers) if isinstance(layers, int) else layers
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pp = init_params(pcfg, generator=torch.Generator(device=device).manual_seed(0),
                     device=device)
    out["phi4"] = sharded_check(pp, pcfg, 1, pn, {"x".join(map(str, pshape)): grid_of(
        pshape, [device])}, device, placed=False)
    out["phi4"]["parameters"] = sum(p.numel() for p in tree_leaves(pp))
    del pp
    lap("b_phi4")
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count >= 2:
        k = next(c for c in SHARDED_CARDS if c <= count)
        cards = [torch.device("cuda", i) for i in range(k)]
        out["cards"] = sharded_state_steps(cfg, b, n, {f"1x{k}": grid_of((1, k), cards)},
                                           share=True)
        one = out["vq_opt_steps"].get(f"1x{k}")
        if one is not None:  # the same grid on one card: the same losses
            got = out["cards"][f"1x{k}"]["lm_loss"]
            if any(abs(a - c) > TRAIN_LOSS_TOL * max(1.0, abs(c))
                   for a, c in zip(got, one["lm_loss"])):
                raise AssertionError(f"{k} cards: losses {got}, on one card {one['lm_loss']}")
            out["cards"]["losses_bitwise_one_card"] = got == one["lm_loss"]
        lap("c_cards")
    else:
        out["cards"] = {"skipped": "needs 2 cards"}
    if count >= 4:
        out["deepseek_v2"] = deepseek_cards_steps(
            deepseek_cut("deepseek-v2-236b", 1, 1), 1024,
            [torch.device("cuda", i) for i in range(4)])
        lap("d_deepseek_v2")
    else:
        out["deepseek_v2"] = {"skipped": "needs 4 cards"}
    out["laps_s"] = laps
    return out


# phase 23: (a) the long-context decode: arch, cache length (long_500k's),
# greedy steps, the (data, model) grid; (b) batch decode: (arch, layers,
# batch, cache length, steps) on a (2, 2) grid; (c) recurrent train steps:
# (arch, tokens) on a (1, 2) grid
SHARDED_LONG = ("hymba-1.5b", 524288, 4, (4, 1))
SHARDED_BATCH = (("phi4-mini-3.8b", 4, 8, 32768, 8), ("rwkv6-7b", 4, 8, 32768, 8))
SHARDED_BATCH_GRID = (2, 2)
SHARDED_RECURRENT = (("rwkv6-7b", 2048), ("hymba-1.5b", 2048))
SHARDED_RECURRENT_GRID = (1, 2)
ATTENTION_CACHES = ("k", "v", "ckv", "krope")  # decode cache leaves a token at a slot


def hymba_cut(n_global: int, n_local: int, vqt: bool = True):
    """hymba-1.5b at full width: a global layer, ``n_local`` windowed
    layers, then ``n_global - 1`` global layers."""
    from repro_torch.configs import get_config

    full = get_config("hymba-1.5b", vqt=vqt)
    glob, local = full.stages[0][0][0], full.stages[1][0][0]
    stages = (((glob,), 1), ((local,), n_local)) + ((((glob,), n_global - 1),)
                                                   if n_global > 1 else ())
    return dataclasses.replace(full, n_layers=n_global + n_local, stages=stages).validate()


def fill_caches(caches: list, gen: torch.Generator, length: int) -> list:
    """Decode caches drawn from ``gen`` (normal: k / v scaled 0.5, the
    recurrent states and carries 0.1) with every ``len`` set to
    ``length``: a long context without its prefill."""
    from repro_torch.common.pytree import path_entry_name, tree_map_with_path
    from repro_torch.models.transformer import set_cache_length

    def one(path, leaf):
        if not leaf.is_floating_point():
            return leaf
        scale = 0.5 if path_entry_name(path[-1]) in ATTENTION_CACHES else 0.1
        return torch.randn(leaf.shape, generator=gen, device=leaf.device).mul_(scale)

    return set_cache_length(tree_map_with_path(one, caches), length)


def greedy_steps(params, cfg, caches, first, pos0: int, steps: int, grid, device) -> dict:
    """``steps`` greedy decode steps under ``grid`` from ``caches`` (placed
    with one copy an entry when the grid has more than one) and the [b, 1]
    ``first`` tokens at position ``pos0``, the parameters placed once
    before the loop: the tokens and logits a step, ms a step (host clock,
    each ending in a sync), the kernels' launches and the collectives'
    bytes over the steps (all, and those that crossed devices), the
    parameter bytes the placement copied to other devices, the cache
    replicas checked bitwise after the steps."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.distributed.context import GRID_STATS, reset_grid_stats, use_mesh
    from repro_torch.launch.sharding import place, place_caches
    from repro_torch.models import transformer as T

    b = first.shape[0]
    placed_bytes = 0
    if grid.devices.size > 1:
        caches = place_caches(caches, grid, batch=b, share=False)
        home = tree_leaves(params)[0].device
        params = place(params, grid, copy=False)
        placed_bytes = sum(t.numel() * t.element_size() for leaf in tree_leaves(params)
                           if hasattr(leaf, "distinct")
                           for t in leaf.distinct() if t.device != home)
    _, launches = launch_counters()
    reset_launches()
    reset_grid_stats()
    cur, toks, logits, ms = first, [], [], []
    with torch.no_grad(), use_mesh(grid):
        for i in range(steps):
            sync_all(device)
            t0 = time.perf_counter()
            out, caches = T.decode_step(params, cfg, cur, caches, torch.full(
                (b, 1), pos0 + i, dtype=torch.int32, device=device))
            cur = out[:, -1].argmax(-1).to(torch.int32)[:, None]
            sync_all(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(cur)
            logits.append(out)
    replicas = unequal = 0
    for leaf in tree_leaves(caches):
        for held in getattr(leaf, "replicas", lambda: [])():
            replicas += len(held) - 1
            unequal += sum(not torch.equal(held[0][1], t.to(held[0][1].device))
                           for _, t in held[1:])
    return dict(tokens=torch.cat(toks, 1), logits=torch.cat(logits, 1), ms=ms,
                launches={k: v for k, v in launches().items() if v},
                collective_bytes=dict(GRID_STATS["bytes"]),
                device_bytes=dict(GRID_STATS["device_bytes"]), placed_bytes=placed_bytes,
                replicas=replicas, unequal_replicas=unequal)


def decode_grid_check(params, cfg, caches, first, pos0: int, steps: int, grids: dict,
                      device) -> dict:
    """``greedy_steps`` under the 1x1 grid of ``device`` and under each of
    ``grids`` from the same caches: the greedy tokens equal, the logits
    within the decode gate (``rows_close``), every cache replica bitwise
    equal; ms a step (mean of the steps after the first), bytes by kind,
    launches, the peak memory over the runs."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    base = greedy_steps(params, cfg, caches, first, pos0, steps, grid_of((1, 1), [device]),
                        device)
    out = {"steps": steps, "ms_step_1x1": float(np.mean(base["ms"][1:] or base["ms"])),
           "ms_1x1": base["ms"], "launches_1x1": base["launches"], "grids": {}}
    for name, grid in grids.items():
        r = greedy_steps(params, cfg, caches, first, pos0, steps, grid, device)
        if not torch.equal(r["tokens"], base["tokens"]):
            raise AssertionError(f"decode {cfg.name} {name}: greedy tokens "
                                 f"{r['tokens'].tolist()} against {base['tokens'].tolist()}")
        close = rows_close(f"decode {cfg.name} {name}", r["logits"], base["logits"], None)
        if r["unequal_replicas"]:
            raise AssertionError(f"decode {cfg.name} {name}: {r['unequal_replicas']} of "
                                 f"{r['replicas']} cache replicas differ")
        out["grids"][name] = dict(ms_step=float(np.mean(r["ms"][1:] or r["ms"])), ms=r["ms"],
                                  max_logits_diff=close["max_logits_diff"],
                                  launches=r["launches"], collective_bytes=r["collective_bytes"],
                                  device_bytes=r["device_bytes"],
                                  placed_param_bytes=r["placed_bytes"],
                                  replicas_checked=r["replicas"], replicas_bitwise=True)
        del r
    out["tokens"] = base["tokens"].tolist()
    out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" \
        else None
    return out


def cache_gb(caches) -> dict:
    """The caches' GB: the attention k / v (or latents) of full and of ring
    (windowed) layers, and the rest."""
    from repro_torch.common.pytree import path_entry_name, tree_flatten_with_path

    out = {"attention": 0.0, "other": 0.0}
    for path, leaf in tree_flatten_with_path(caches):
        kind = "attention" if path_entry_name(path[-1]) in ATTENTION_CACHES else "other"
        out[kind] += leaf.numel() * leaf.element_size() / 1e9
    return out


def decode_run(cfg, b: int, length: int, steps: int, grids: dict, device, seed: int = 0
               ) -> dict:
    """Phase 23 (a) and (b): ``cfg`` (weights on ``device``'s generator
    from ``seed``) at batch ``b``, caches of ``length`` slots drawn from
    the generator with ``len`` ``length - steps - 1`` (``fill_caches``);
    ``decode_grid_check`` over ``grids``."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, generator=gen, device=device)
    start = length - steps - 1
    caches = fill_caches(T.init_caches(cfg, b, length, device=device), gen, start)
    first = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=device, dtype=torch.int32)
    out = decode_grid_check(params, cfg, caches, first, start, steps, grids, device)
    out.update(layers=n_layers(cfg), batch=b,
               parameters=sum(t.numel() for t in tree_leaves(params)), cache_len=length,
               cache_gb=cache_gb(caches),
               global_layers=sum(layer.window is None for layer in cfg.layer_list()))
    del params, caches
    return out


def sharded_decode_phase(long=None, batch=None, recurrent=None, device=None) -> dict:
    """Phase 23: the decode caches and the recurrent mixers run by their
    plans, on grids whose entries repeat the card. (a) ``long`` ((cfg,
    length, steps) pairs; default hymba-1.5b VQT and plain, full width and
    depth, at ``long_500k``'s 524,288 tokens, 4 greedy steps) on
    ``SHARDED_LONG``'s (4, 1) grid (the sequence over 4 rows). (b)
    ``batch`` ((cfg, b, length, steps); default phi4-mini VQT and
    rwkv6-7b, 4 layers, batch 8, 32,768 tokens, 8 steps) on
    ``SHARDED_BATCH_GRID``. (c) ``recurrent`` ((cfg, tokens); default
    rwkv6-7b and hymba-1.5b at full width, 4 layers, [1, 2048]):
    ``sharded_check`` on ``SHARDED_RECURRENT_GRID`` laid out in the
    forward, each gradient leaf's gate at the 1x1 step's one-ulp floor
    (``ulp_floor``). With four cards also (a)'s first model with the
    sequence over the four cards, and rwkv6-7b trained at full width and
    depth on a (1, 4) grid of them (``deepseek_cards_steps``; running out
    of memory fails the phase)."""
    from repro_torch.common.pytree import tensor_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    device = torch.device(device or DEVICE)
    laps, lap = stopwatch()
    on = lambda g: {"x".join(map(str, g)): grid_of(g, [device])}  # noqa: E731
    long = long or [(get_config(SHARDED_LONG[0], vqt=vqt), SHARDED_LONG[1], SHARDED_LONG[2])
                    for vqt in (True, False)]
    batch = batch or [(family_train_cfg(a, layers), b, length, steps)
                      for a, layers, b, length, steps in SHARDED_BATCH]
    recurrent = recurrent or [(family_train_cfg("rwkv6-7b", 4), SHARDED_RECURRENT[0][1]),
                              (hymba_cut(2, 2), SHARDED_RECURRENT[1][1])]

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    out = {"long": [], "batch": [], "train": []}
    for cfg, length, steps in long:
        out["long"].append(dict(arch=cfg.name, vqt=cfg.vqt is not None, **decode_run(
            cfg, 1, length, steps, on(SHARDED_LONG[3]), device)))
        free()
    lap("a_long")
    for cfg, b, length, steps in batch:
        out["batch"].append(dict(arch=cfg.name, vqt=cfg.vqt is not None, **decode_run(
            cfg, b, length, steps, on(SHARDED_BATCH_GRID), device)))
        free()
    lap("b_batch")
    for cfg, n in recurrent:
        params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                             device=device)
        with gated_attention_census() as census:
            r = sharded_check(params, cfg, 1, n, on(SHARDED_RECURRENT_GRID), device,
                              placed=False, ulp_floor=True)
        r.update(arch=cfg.name, parameters=sum(t.numel() for t in tensor_leaves(params)),
                 gated_attention_calls=census)
        out["train"].append(r)
        del params
        free()
    lap("c_train")
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count >= 4:
        cards = [torch.device("cuda", i) for i in range(4)]
        cfg, length, steps = long[0]
        out["long_cards"] = decode_run(cfg, 1, length, steps,
                                       {"4x1_cards": grid_of((4, 1), cards)}, device)
        free()
        lap("a_cards")
        out["rwkv6_cards"] = deepseek_cards_steps(family_train_cfg("rwkv6-7b", None),
                                                  SHARDED_RECURRENT[0][1], cards)
        free()
        lap("rwkv6_cards")
    else:
        out["long_cards"] = out["rwkv6_cards"] = {"skipped": "needs 4 cards"}
    out["laps_s"] = laps
    return out


def edit_roofline(srv, cfg, shapes: dict, busy_ms: float) -> dict:
    """Phase 8's dispatches priced by ``launch.roofline``: each (B, n_cap,
    C, R) of the profiled round at the module's H100 peaks and the
    engine's weight bytes; the analytic floor summed over the round beside
    the round's measured device busy ms (numbers, no gate). ``xla_flops`` is
    ``FlopCounterMode``'s count of one dispatch of the shape (replaces on
    every slot of a fresh batch): the aten ops it sees, not the
    hand-written kernels' products (ctypes calls), nor any bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline

    rows, floor = [], 0.0
    rng = np.random.default_rng(0)
    for (B, n_cap, C, R), calls in sorted(shapes.items()):
        eng = srv.engine(C, R)
        st = eng.batch_full_forward(rng.integers(0, cfg.vocab, (B, n_cap)),
                                    np.tile(np.arange(n_cap), (B, 1)))
        slot = np.tile(np.arange(C), (B, 1))
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            eng.batch_apply_replaces(st, slot, rng.integers(0, cfg.vocab, (B, C)))
        rep = roofline.edit_step_roofline(eng.L, eng.meta, n_cap, C, R,
                                          xla_flops=fc.get_total_flops(), xla_bytes=0,
                                          weight_bytes=tensor_bytes(eng.W), batch=B,
                                          d_ff=cfg.d_ff)
        ms = max(rep.compute_s, rep.memory_s) * 1e3
        floor += ms * calls
        rows.append(dict(B=B, n_cap=n_cap, C=C, R=R, dispatches=calls, floor_ms=ms,
                         **rep.summary()))
        del st
    return dict(peak_flops=roofline.PEAK_FLOPS, hbm_bw=roofline.HBM_BW, shapes=rows,
                floor_ms_round=floor, device_busy_ms=busy_ms)


@contextlib.contextmanager
def dispatch_census(srv):
    """Count the (B, n_cap, C, R) of ``srv``'s edit dispatches while the
    block runs (its ``_count_shape`` calls). Yields the dict that fills."""
    shapes: dict = {}
    count = srv._count_shape

    def counted(shape):
        if shape[0] == "edit":
            shapes[shape[1:]] = shapes.get(shape[1:], 0) + 1
        return count(shape)

    with mock.patch.object(srv, "_count_shape", counted):
        yield shapes


def train_4k_len() -> int:
    """``SHAPES["train_4k"].seq_len`` of the port's ``launch/specs.py``."""
    from repro_torch.launch.specs import SHAPES

    return SHAPES["train_4k"].seq_len


SWEEPS = ("delta_gate", "vq_assign", "patch", "gated_attention", "gated_attention_bwd")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", nargs="?", const=",".join(SWEEPS), metavar="NAMES",
                   help="after the build, only time delta_gate over r with each "
                        "launch shape forced, vq_assign over token counts with each "
                        "schedule forced, fused_step and incr_patch over (B, n, C), "
                        "gated_attention over (BH, nq, nk) and its backward over "
                        "(BH, n); a comma list of "
                        f"{SWEEPS} picks some (no other phase, no ok line)")
    p.add_argument("--phase", choices=("sharded_train", "sharded_decode"),
                   help="after the build, only phase 22 (with 4 cards visible its (c) "
                        "and (d) across cards) or phase 23 (with 4 cards its long decode "
                        "and rwkv6-7b's training across them); no other phase, no ok line")
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
                      gated_attention=lambda g: sweep_gated_attention(gak, g),
                      gated_attention_bwd=lambda g: sweep_gated_attention_bwd(gak, g))
        for name in args.sweep.split(","):
            sweeps[name](torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if args.phase:
        t0 = time.perf_counter()
        run = sharded_phase if args.phase == "sharded_train" else sharded_decode_phase
        emit(args.phase, **run(), seconds=time.perf_counter() - t0, nvidia_smi=smi)
        print(smi, flush=True)
        return 0

    # ---- 3. kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused = [check_fused_step(ops, ref, gen, C) for C in (8, 72, 264)]
    fused.append(check_fused_step(ops, ref, gen, 72, causal=True))
    fused_single = check_fused_step_single(ops, gen)
    gates = [check_delta_gate(ops, ref, gen, r, timed=True) for r in SWEEP_GATE[:-1]]
    floor = launch_floor()
    vqs = [check_vq_assign(vqk, gen, B, N) for B, N in ((4, 1024), (1, 1024), (1, 32), (1, 1))]
    vqs += [check_vq_assign(vqk, gen, 1, N, dv=dv) for N, dv in FAMILY_VQ]
    gas = [check_gated_attention(gak, gen, n) for n in (1024, 1000, 37)]
    gas.append(check_gated_attention(gak, gen, 1024, BH=96))  # the train step's
    gas += [check_gated_attention(gak, gen, nq, nk, BH=BH, dh=dh)
            for BH, nq, nk, dh in WIDE_ATTENTION + HYMBA_ATTENTION]
    gabs = [check_gated_attention_bwd(gak, gen, n, BH=BH) for BH, n in BWD_ATTENTION]
    gabs += [check_gated_attention_bwd(gak, gen, n, BH=BH, dh=dh) for BH, n, dh in BWD_FAMILIES]
    ips = [check_incr_patch(ipk, gen, C) for C in (8, 72, 264)]
    ips.append(check_incr_patch(ipk, gen, 1032, B=1))  # the most served step
    emit("kernels", seconds=time.perf_counter() - t0, fused_step=fused,
         fused_step_single=fused_single, delta_gate=gates, launch_floor=floor, vq_assign=vqs, gated_attention=gas,
         gated_attention_bwd=gabs, incr_patch=ips)

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
            if logit_diff[did] > 3e-4:
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
    with fused_step_census() as census, dispatch_census(srv) as dispatches:
        prof = profile_round(srv, make_stream(
            cfg.vocab, seed=1, rounds=1, lens={d: srv.docs[d].n for d in docs})[0])
    prof["fused_step_shapes"] = census
    prof["roofline"] = edit_roofline(srv, cfg, dispatches, prof["device_busy_ms"])
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
    tier = tiered_phase(params, cfg, docs, stream[:2])
    emit("tiered", seconds=time.perf_counter() - t0, nvidia_smi=smi, **tier)

    # ---- 12. async: concurrent clients through the deadline batcher
    t0 = time.perf_counter()
    asy = async_phase(params, cfg, docs, stream[:2])
    emit("async", seconds=time.perf_counter() - t0, nvidia_smi=smi, **asy)

    # ---- 13. fleet: two replica workers on the card, migration, failover
    t0 = time.perf_counter()
    flt = fleet_phase(params, cfg, docs, stream)
    emit("fleet", seconds=time.perf_counter() - t0, nvidia_smi=smi, **flt)

    # ---- 14. incremental: the paper's op-counting path, and the oracle
    t0 = time.perf_counter()
    inc = incremental_phase(params, cfg, docs, stream, srv)
    emit("incremental", seconds=time.perf_counter() - t0, nvidia_smi=smi, **inc)

    # ---- 15. mesh: the document axis over k blocks
    t0 = time.perf_counter()
    msh = mesh_phase(params, cfg, docs, stream)
    emit("mesh", seconds=time.perf_counter() - t0, nvidia_smi=smi, **msh)

    # ---- 16. families: the dense-attention model families
    t0 = time.perf_counter()
    del srv
    gc.collect()  # the earlier phases' servers, held in reference cycles
    torch.cuda.empty_cache()
    fam = dict(phi4=phi4_phase(), gemma3=gemma3_phase(), smoke=smoke_families())
    emit("families", seconds=time.perf_counter() - t0, nvidia_smi=smi, **fam)

    # ---- 17. recurrent: rwkv6 and hymba
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(rwkv6=rwkv6_phase(), hymba=hymba_phase(), hymba_ring=hymba_ring_phase())
    emit("recurrent", seconds=time.perf_counter() - t0, nvidia_smi=smi, **rec)

    # ---- 18. moe: MLA, MoE and MTP at deepseek-v2 and -v3 width
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    moe = dict(deepseek_v2=deepseek_v2_phase())
    gc.collect()
    torch.cuda.empty_cache()
    moe["deepseek_v3"] = deepseek_v3_phase()
    emit("moe", seconds=time.perf_counter() - t0, nvidia_smi=smi, **moe)

    # ---- 19. train: Gumbel-VQ training, distillation, pytree checkpoints
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    trn = train_phase()
    emit("train", seconds=time.perf_counter() - t0, nvidia_smi=smi, **trn)

    # ---- 20. family_train: every family's training, five at full width
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ftr = family_train_phase(steps=2)
    emit("family_train", seconds=time.perf_counter() - t0, nvidia_smi=smi, **ftr)

    # ---- 21. grid: the model axis, expert-parallel MoE at deepseek-v2 width
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    grd = grid_phase()
    emit("grid", seconds=time.perf_counter() - t0, nvidia_smi=smi, **grd)

    # ---- 22. sharded_train: the train step run by the sharding plan
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shd = sharded_phase()
    emit("sharded_train", seconds=time.perf_counter() - t0, nvidia_smi=smi, **shd)

    # ---- 23. sharded_decode: the decode caches' and the recurrent mixers' plans
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sdc = sharded_decode_phase()
    emit("sharded_decode", seconds=time.perf_counter() - t0, nvidia_smi=smi, **sdc)

    # ---- summary
    c72 = next(f for f in fused if f["C"] == 72 and f["mask"] == "random")
    r_top = max(gate_rows, key=gate_rows.get)  # the most served r
    gate_top = (next((g for g in gates if g["r"] == r_top), None)
                or check_delta_gate(ops, ref, gen, r_top, timed=True))
    kernels = [
        dict(name="fused_step", route="cuda", source="src/repro_torch/csrc/fused_step.cu",
             replaces="src/repro/kernels/fused_step/fused_step.py:179",
             launches=serve_launches["fused_step"],
             mesh_launches=msh["launches"]["fused_step"],
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
    vq1024 = next(v for v in vqs if v["B"] == 1 and v["N"] == 1024 and v["dv"] == 384)
    ga1024 = next(g for g in gas if g["BH"] == 48 and g["nq"] == 1024 and g["dh"] == 64)
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
    # the families' shapes: launches from the phase 16 and 17 forwards (one
    # phi4 forward, one gemma3 pattern forward, one hymba forward)
    shape_row = lambda g, launches: dict(  # noqa: E731
        dh=g["dh"], BH=g["BH"], n=g["nq"], launches=launches, max_abs_err=g["max_abs_err"],
        ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"], bound_by=g["bound_by"],
        library_ms=None)
    family_launches = {128: fam["phi4"]["launches"]["gated_attention"],
                       256: fam["gemma3"]["launches"]["gated_attention"]}
    wide = [shape_row(g, family_launches[g["dh"]])
            for g in gas if g["dh"] != 64 and g["nq"] != 1000]
    ga_hymba = next(g for g in gas if g["BH"] == 25 and g["nq"] == 4096)
    next(k for k in kernels if k["name"] == "gated_attention").update(
        cores=GA_CORES, bound_fp32_ms=ga1024["bound_fp32_ms"],
        bound_tc_3xtf32_ms=ga1024["bound_tc_3xtf32_ms"], head_dims=wide,
        hymba=shape_row(ga_hymba, rec["hymba"]["launches"]["gated_attention"]))
    # the families' forwards: one phi4 forward (dv 1536), one gemma3 pattern
    # forward (dv 2048), one hymba forward (dv 800), one cut deepseek-v2
    # forward (dv 8192)
    for dv, N, launches in ((1536, 4096, fam["phi4"]["launches"]["vq_assign"]),
                            (2048, 3072, fam["gemma3"]["launches"]["vq_assign"]),
                            (800, 4096, rec["hymba"]["launches"]["vq_assign"]),
                            (8192, 4096, moe["deepseek_v2"]["launches"]["vq_assign"])):
        row = next(v for v in vqs if v["dv"] == dv and v["N"] == N)
        next(k for k in kernels if k["name"] == "vq_assign")[f"dv{dv}"] = dict(
            N=N, launches=launches,
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None)
    # the backward: launches from the train phase's 8 full-size steps; by
    # head dim from the family_train phase's steps
    kernels.append(bwd_kernel_entry(
        gabs, sum(v for k, v in trn["train"]["launches"].items() if "bwd" in k),
        head_dims=ftr["bwd_launches_by_head_dim"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
