// Hand-written Hopper (sm_90a) kernels of the gradient of causal sigma
// (GELU-gated) attention, on the tensor cores in 3xTF32.
//
// The forward is csrc/gated_attention.cu (the port of the TPU Pallas kernel
// src/repro/kernels/gated_attention/gated_attention.py, pallas_call at :90).
// No TPU kernel has a backward: the reference trains by differentiating its
// plain-JAX sigma attention (src/repro/models/attention.py: attention_core).
// These kernels compute that gradient, for training's nq = nk = n and
// dh = dv = 64, and (the "wide heads" kernels below) 128 and 256. With c_i = i + 1, S = q k^T * scale, W = gelu_tanh(S) * mask
// (key j <= query i) and dO' = dO / c:
//   dV = W^T dO'       dW = dO' V^T       dS = dW * gelu_tanh'(S) * mask
//   dQ = dS K * scale  dK = dS^T Q * scale
// S and W are recomputed here from q and k; the forward saves nothing else.
//
// The route is the forward's (tf32_mma.cuh): mma.sync.m16n8k8 TF32 products
// with FP32 accumulation, every operand split into a TF32 big part and the
// rest, each product taken as small*big + big*small + big*big.
//
// Two kernels, no atomics, so every sum runs in a fixed order and two calls
// give the same bits (FlashAttention-2's backward without the softmax and
// without the atomic dQ). Each is a CTA of 4 warps per (64-row tile, bh),
// 16 rows a warp, that stages its own two tiles once and streams the other
// side's tiles through shared memory with 16-byte cp.async copies.
// * dkv: a key tile. It streams the query tiles at or after it, from the
//   last down to the diagonal (see below), in passes of 32 queries (four
//   8-query groups). A pass computes S^T = K Q^T and dW^T = V dO^T (the
//   warp's 16 keys x 32 queries), then, in registers, one exponential a
//   (key, query) pair, W^T = gelu and dS^T = dW^T gelu' from it, and takes
//   each C fragment as the A fragment of dV += W^T dO' and dK += dS^T Q as
//   it stands: no trip through shared memory, no barrier.
// * dq: a query tile. It streams the key tiles at or before it, and per
//   pass of 32 keys computes S = Q K^T and dW = dO V^T, dS in registers,
//   then dQ += dS K. S and dW are computed in both kernels: 7 products
//   where the gradient needs 5 (one write of dS to device memory would
//   save two; ROADMAP).
// * Streamed tiles are split once. Every warp reads the streamed tiles as
//   B operands, in both roles (below), so split at each use each element
//   was split 8 times a tile (3 instructions each). After a tile lands,
//   the CTA splits it once, in place (big part) and beside it (small
//   part), and the products load both parts. The stage then holds 4
//   tiles; two stages would need 184 KB, one CTA an SM, so there is one
//   stage, and the other CTA on the SM runs while a copy is in flight.
//   Against the double-buffered kernels that split at each use, in one
//   call (tools/time_bwd_variants.py, BH = 96, n = 1024, two runs each):
//   dkv 0.6433 / 0.6469 -> 0.5254 / 0.5215 ms, dq 0.3809 / 0.3813 ->
//   0.3800 / 0.3782.
// * dO' = dO / c is folded in as a reciprocal in registers: dkv scales
//   W^T's and dW^T's query columns by 1 / c (8 reciprocals a pass), dq its
//   dW rows (2 a thread, once). cp.async copies raw bytes, so no staging
//   step divides; a pass over dO before the launches would cost a launch
//   and 2 x 4 B an element.
// * The causal mask applies only on the diagonal tile; there a warp skips
//   the 8-row groups wholly before its first key (dkv) or after its last
//   query (dq). The CTAs of the heaviest tiles come first in the grid. Rows
//   at or past n stage as zeros (cp.async's zero fill): a zero query row
//   has zero S, W and dO', a zero key row zero S^T and dW^T, and neither is
//   written back.
//
// What was hard.
// * Accumulation order. The tensor core truncates each MMA's sum to f32,
//   so a long chain of MMAs into one accumulator drifts by up to an ulp of
//   the running sum each time. dK of key j sums 384 MMAs over the queries,
//   and its largest terms are the first queries (dO' = dO / c). Walking the
//   query tiles upward made dk miss the 1e-5 gate (1.3e-5 of its max at
//   BH = 96, n = 1024); walking them downward, the small terms first, gives
//   2.2e-6, at no cost. dQ sums terms of one size (c is the row's) and
//   walks the key tiles upward.
// * Tiles read in two roles. In dkv, q and dO' are each read as B of a
//   product reduced over dh (S^T, dW^T: a 2-float load of row r, dims 2t,
//   2t + 1, the dims renumbered inside each 8-wide k-step as the forward
//   does) and as B of a product reduced over queries (dK, dV: scalars of
//   two rows, column g). In dq, k is read both ways. One stride serves both
//   without a bank conflict, through the order of the rows within each
//   8-row group: the C fragment's columns (2t, 2t + 1) become the next
//   product's k-step columns (t, t + 4), and that k-step column c reads row
//   sigma(c) of the group, sigma = (0, 1, 2, 3, 6, 7, 4, 5); so column n of
//   the first product reads row sigma(n / 2 + 4 (n % 2)) =
//   (0, 6, 1, 7, 2, 4, 3, 5)[n]. With rows of 72 floats (8 mod 32 banks)
//   the first role's half-warps read rows {0, 6, 1, 7} and {2, 4, 3, 5},
//   the second's 4 rows {0, 1, 2, 3} or {6, 7, 4, 5}: 8-bank blocks 0, 16,
//   8, 24 in each, every bank once. The warp's own 16 rows (k and v in dkv,
//   q and dO in dq) are A operands, read per k-step as 2-float loads of
//   rows g and g + 8 and split there.
// * Registers. dkv holds dK and dV (64 registers) and a pass's S^T and
//   dW^T (32); its own rows stay in shared memory, as in registers they
//   would take 64 more. Two choices keep it from spilling at two CTAs an
//   SM: the products reduced over rows take four of their eight 8-column
//   groups at a time (with eight, it spilled), and each k-step of the
//   products reduced over dh runs S's three products, then dW's (with the
//   two interleaved, 56 B of spills).
//
// Resources (ptxas, and cudaFuncSetAttribute's shared memory): dkv 255
// registers, dq 187, no spills; 110,592 B of shared memory a CTA (the own
// two tiles, the streamed two, their small parts; rows of 72 floats), so
// two CTAs (8 warps) an SM for each.
//
// What bounds it on an H100: operations. At the VQ-OPT-125M train step's
// shape (BH = 96, n = 1024, dh = 64) the gradient needs 5 products (S, dW,
// dV, dK, dQ) over 524,800 causal (query, key) pairs a bh, 32.2 GFLOP:
// 0.195 ms as 3xTF32 on the tensor cores (495 TFLOP/s), 0.481 ms at the
// 67 TFLOP/s of the FP32 cores. These kernels do 7, 45.1 GFLOP. q, k, v,
// dO and the three gradients are 176 MB, 0.053 ms at 3.35 TB/s. What holds
// them: the MMAs, then the GELU. In one call (tools/time_bwd_variants.py,
// BH = 96, n = 1024), one TF32 product in place of three takes dkv from
// 0.5254 to 0.3160 ms and dq from 0.3800 to 0.2361; no GELU takes dkv to
// 0.4820 (dq to 0.2555, where S, then unused, goes too). mma.sync runs
// TF32 at about half the rate that wgmma reaches (the forward's note).
//
// Wide heads (dh = D = 128, 256: the heads of phi4-mini and of gemma3's
// global layers). The same two kernels, templated on D, with what D changes:
// * Accumulators. dK and dV over all D columns would take 2 x D / 2
//   registers a thread (256 at D = 256), so a CTA owns a slice of SL = 128
//   output columns (a third grid axis: one slice at D = 128, two at 256)
//   and S^T and dW^T, reduced over all D, are computed once a slice. With
//   64-column slices, as the forward's chunks, the kernels recomputed S and
//   dW 2 and 4 times; 128 columns cost dkv 92 B (D = 128) and 36 B
//   (D = 256) of spills at 255 registers and take the BH = 24 / 16,
//   n = 4096 calls from 13.61-13.69 / 35.96-36.14 ms to 8.05-8.13 /
//   19.59-19.65 ms (tools/time_bwd_variants.py, A B B A in one call,
//   NVIDIA H100 80GB HBM3, 700.00 W).
// * Shared memory. The own two tiles keep all D columns (64 rows of
//   D + 8 floats: 8 mod 32 banks, so the row order above still reads
//   every bank once); the streamed tiles shrink to SR = 32 rows (D = 128)
//   or 16 (D = 256), a pass being one streamed tile (SR / 8 groups):
//   139,264 B and 202,752 B a CTA, one CTA (4 warps) an SM.
// * Walks and masks. dK/dV walks the query tiles from the last down, as
//   at dh = 64; a streamed tile of 16 or 32 rows meets a 64-row key tile's
//   diagonal in 4 or 2 tiles, where groups wholly before a warp's first
//   key (dkv) or after its last query (dq) are skipped and the rest
//   masked.
// The dh = 64 kernels' code is untouched: their SASS is the same as before
// the wide kernels were added beside them (chip_smoke.py's sass_md5).
//
// Measured (chip_smoke.py from a git archive of this tree, NVIDIA H100
// 80GB HBM3, 700.00 W; device ms; the FP32-core kernels these replace in
// the same call in parentheses): BH = 96, n = 1024 (the train step) 0.8900
// (2.0904), dK/dV 0.5158, dQ 0.3742: 4.6x the 0.195 ms 3xTF32 bound, 1.8x
// the FP32-core one, plain 8.51; BH = 48 at n = 1024 / 1000 / 37 / 1:
// 0.4748 / 0.4778 / 0.0237 / 0.0227 (1.0166 / 1.0136 / 0.0278 / 0.0261);
// --sweep, BH = 48 at n = 128 / 256 / 512 / 2048: 0.0382 / 0.0665 /
// 0.1513 / 1.6517 (0.0495 / 0.1055 / 0.2918 / 3.8638). Within 3.1e-6 of
// the plain version's max everywhere (gate 1e-5). A VQ-OPT-125M train
// step at [8, 1024]: 251.2 ms (266.2).
//
// Plain C interface, loaded with ctypes; each launcher returns the CUDA error
// code so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "patch_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using repro_torch::patch_tile::cp_async16;
using repro_torch::patch_tile::cp_async_commit;
using repro_torch::patch_tile::cp_async_wait;
using repro_torch::tf32::mma;
using repro_torch::tf32::split;

constexpr int DH = 64;                 // head dim of q, k and v
constexpr int BT = 64;                 // rows (queries or keys) of a tile
constexpr int WARPS = BT / 16;         // 16 rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int PASS = 4;                // 8-row groups a pass
constexpr int LD = DH + 8;             // padded stride (floats) of a staged row
constexpr int TILE = BT * LD;          // floats of one staged tile
constexpr int SMALL = 2 * TILE;        // a streamed tile's small part, past its big part
// the own two tiles, then the streamed two as big parts and as small parts
constexpr int SMEM_BYTES = 6 * TILE * (int)sizeof(float);  // 110,592 B

// Row of an 8-row group read by k-step column t (lo) and t + 4 (hi) of the
// products reduced over rows; b_row(n): the row read by column n of the
// products reduced over dh, whose C columns (2t, 2t + 1) are those k-step
// columns (t, t + 4).
__device__ __forceinline__ int lo_row(int t) { return t; }
__device__ __forceinline__ int hi_row(int t) { return 4 + ((t + 2) & 3); }
__device__ __forceinline__ int b_row(int n) { return (n & 1) ? hi_row(n >> 1) : lo_row(n >> 1); }

// The tanh GELU of common.cuh, w = x (1 + tanh u) / 2 with u = beta (x +
// kappa x^3), and its derivative, from one exponential and one reciprocal:
// with r = 1 / (1 + e^(2u)), 1 + tanh u = 2 (1 - r) and 1 - tanh^2 u =
// 4 r (1 - r), so w = x (1 - r) and w' = (1 - r) (1 + 2 beta x r (1 + 3
// kappa x^2)). The fast forms (__expf, __fdividef: one MUFU op each) err
// by ~1e-7 in r, far under the backward's tolerance; e^(2u) = inf gives
// r = 0, w = x, w' = 1.
__device__ __forceinline__ void gelu_and_grad(float x, float& w, float& grad) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x2 = x * x;
  const float r = __fdividef(1.0f, 1.0f + __expf(2.0f * kBeta * x * (1.0f + kKappa * x2)));
  const float omr = 1.0f - r;
  w = x * omr;
  grad = omr * (1.0f + 2.0f * kBeta * x * r * (1.0f + 3.0f * kKappa * x2));
}

// Rows row0 .. row0 + 63 of a [n, 64] matrix into a staged tile (zeros past n).
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < BT * DH / 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / (DH / 4), c = 4 * (e % (DH / 4));
    const bool in = row0 + r < n;
    cp_async16(dst + r * LD + c, src + (size_t)(in ? row0 + r : 0) * DH + c, in);
  }
}

// The two streamed tiles at p (as copied) split in place: the big part
// stays, the small part goes SMALL floats on. Every warp reads them as B
// operands, so each element is split once here and not once a warp a use.
__device__ __forceinline__ void split_stage(float* p, int tid) {
#pragma unroll
  for (int i = 0; i < 2 * BT * DH / 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int m = e / (BT * DH / 4), r = (e / (DH / 4)) % BT, c = 4 * (e % (DH / 4));
    float* x = p + m * TILE + r * LD + c;
    const float4 v = *reinterpret_cast<const float4*>(x);
    uint4 big, sml;
    split(v.x, big.x, sml.x);
    split(v.y, big.y, sml.y);
    split(v.z, big.z, sml.z);
    split(v.w, big.w, sml.w);
    *reinterpret_cast<uint4*>(x) = big;
    *reinterpret_cast<uint4*>(x + SMALL) = sml;
  }
}

__device__ __forceinline__ uint2 ld2(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The A fragment of k-step ks over the head dim (column t is dim 2t, t + 4
// dim 2t + 1) of the staged rows g and g + 8 from p, split.
__device__ __forceinline__ void a_frag(const float* p, int ks, int g, int t, uint32_t (&big)[4],
                                       uint32_t (&sml)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(p + g * LD + 8 * ks + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(p + (g + 8) * LD + 8 * ks + 2 * t);
  split(lo.x, big[0], sml[0]);
  split(hi.x, big[1], sml[1]);
  split(lo.y, big[2], sml[2]);
  split(hi.y, big[3], sml[3]);
}

// A C fragment as the A fragment of a k-step over its columns (C column 2t
// is A column t, 2t + 1 is t + 4), split.
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&big)[4],
                                       uint32_t (&sml)[4]) {
  split(c[0], big[0], sml[0]);
  split(c[2], big[1], sml[1]);
  split(c[1], big[2], sml[2]);
  split(c[3], big[3], sml[3]);
}

// acc[j] += A B_j for one k-step over the head dim and the pass's 8-row
// groups j (jlo <= j <= jhi where EDGE): A split in (ab, as), B_j's big
// part a 2-float load at p + 8 j LD, its small part SMALL floats on. The
// three products run over the groups in turn: PASS independent MMAs
// between two into one accumulator.
template <bool EDGE>
__device__ __forceinline__ void kstep(float (&acc)[PASS][4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], const float* p, int jlo,
                                      int jhi) {
  uint2 bb[PASS], bs[PASS];
#pragma unroll
  for (int j = 0; j < PASS; ++j) {
    if (EDGE && (j < jlo || j > jhi)) continue;
    bb[j] = ld2(p + 8 * j * LD);
    bs[j] = ld2(p + SMALL + 8 * j * LD);
  }
#pragma unroll
  for (int j = 0; j < PASS; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], as, bb[j].x, bb[j].y);
#pragma unroll
  for (int j = 0; j < PASS; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], ab, bs[j].x, bs[j].y);
#pragma unroll
  for (int j = 0; j < PASS; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], ab, bb[j].x, bb[j].y);
}

// s[j] = X Y^T and w[j] = U Z^T over the head dim for the pass's 8-row
// groups j of Y and Z (jlo <= j <= jhi where EDGE): X and U point at the
// warp's first own row (A, split here), Y and Z at the pass's first
// streamed row (B, split in the stage; column n of group j is row
// 8 j + b_row(n)). Each k-step runs S's products, then dW's.
template <bool EDGE>
__device__ __forceinline__ void scores(float (&s)[PASS][4], float (&w)[PASS][4], const float* X,
                                       const float* U, const float* Y, const float* Z, int g,
                                       int t, int jlo, int jhi) {
#pragma unroll
  for (int j = 0; j < PASS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = w[j][e] = 0.0f;
  const int br = b_row(g) * LD + 2 * t;
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    uint32_t ab[4], as[4];
    a_frag(X, ks, g, t, ab, as);
    kstep<EDGE>(s, ab, as, Y + br + 8 * ks, jlo, jhi);
    a_frag(U, ks, g, t, ab, as);
    kstep<EDGE>(w, ab, as, Z + br + 8 * ks, jlo, jhi);
  }
}

// acc += A Y over one 8-row group of the streamed Y (p points at its first
// row; k-step column t is row lo_row(t), t + 4 row hi_row(t)), all 64
// columns, four 8-column groups at a time (eight spill at two CTAs an SM):
// A is a C fragment taken as it stands.
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const float (&c)[4],
                                           const float* p, int g, int t) {
  uint32_t ab[4], as[4];
  c_as_a(c, ab, as);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(p + lo_row(t) * LD + g);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(p + hi_row(t) * LD + g);
#pragma unroll
  for (int n0 = 0; n0 < DH / 8; n0 += 4) {
    uint32_t yb[4][2], ys[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      yb[n][0] = lo[8 * (n0 + n)];
      yb[n][1] = hi[8 * (n0 + n)];
      ys[n][0] = lo[SMALL + 8 * (n0 + n)];
      ys[n][1] = hi[SMALL + 8 * (n0 + n)];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], as, yb[n][0], yb[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], ab, ys[n][0], ys[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], ab, yb[n][0], yb[n][1]);
  }
}

// One pass of dkv: the warp's keys key0 + (g, g + 8) against the 32
// queries from qp0 (sQ, sO: their first streamed row). DIAG: the diagonal
// tile, masked, groups before jlo skipped.
template <bool DIAG>
__device__ __forceinline__ void dkv_pass(float (&dk)[DH / 8][4], float (&dv)[DH / 8][4],
                                         const float* sK, const float* sV, const float* sQ,
                                         const float* sO, int g, int t, int key0, int qp0,
                                         int jlo, float scale) {
  float s[PASS][4], w[PASS][4];
  scores<DIAG>(s, w, sK, sV, sQ, sO, g, t, jlo, PASS - 1);
  // W^T and dS^T in place, each query column times 1 / c (dO' = dO / c)
#pragma unroll
  for (int j = 0; j < PASS; ++j) {
    if (DIAG && j < jlo) continue;
    const int qlo = qp0 + 8 * j + lo_row(t), qhi = qp0 + 8 * j + hi_row(t);
    const float rc[2] = {1.0f / (float)(qlo + 1), 1.0f / (float)(qhi + 1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = (e & 1) ? qhi : qlo;
      const int key = key0 + g + 8 * (e >> 1);
      float gw, gd;
      gelu_and_grad(s[j][e] * scale, gw, gd);
      const bool live = !DIAG || key <= query;
      s[j][e] = live ? gw * rc[e & 1] : 0.0f;
      w[j][e] = live ? w[j][e] * rc[e & 1] * gd : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < PASS; ++j) {
    if (DIAG && j < jlo) continue;
    accumulate(dv, s[j], sO + 8 * j * LD, g, t);
    accumulate(dk, w[j], sQ + 8 * j * LD, g, t);
  }
}

// One pass of dq: the warp's queries row0 + (g, g + 8) against the 32 keys
// from kp0 (sK, sV: their first streamed row); rc: 1 / c of the two rows.
// DIAG: the diagonal tile, masked, groups after jhi skipped.
template <bool DIAG>
__device__ __forceinline__ void dq_pass(float (&dq)[DH / 8][4], const float* sQ,
                                        const float* sO, const float* sK, const float* sV,
                                        int g, int t, int row0, int kp0, int jhi,
                                        const float (&rc)[2], float scale) {
  float s[PASS][4], w[PASS][4];
  scores<DIAG>(s, w, sQ, sO, sK, sV, g, t, 0, jhi);
  // dS in place
#pragma unroll
  for (int j = 0; j < PASS; ++j) {
    if (DIAG && j > jhi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kp0 + 8 * j + ((e & 1) ? hi_row(t) : lo_row(t));
      const int row = row0 + g + 8 * (e >> 1);
      float gw, gd;
      gelu_and_grad(s[j][e] * scale, gw, gd);
      const bool live = !DIAG || key <= row;
      w[j][e] = live ? w[j][e] * rc[e >> 1] * gd : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < PASS; ++j) {
    if (DIAG && j > jhi) continue;
    accumulate(dq, w[j], sK + 8 * j * LD, g, t);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
gated_attention_bwd_dkv_kernel(const float* __restrict__ q,   // [BH, n, 64]
                               const float* __restrict__ k,   // [BH, n, 64]
                               const float* __restrict__ v,   // [BH, n, 64]
                               const float* __restrict__ dO,  // [BH, n, 64]
                               float* __restrict__ dk,        // [BH, n, 64]
                               float* __restrict__ dv,        // [BH, n, 64]
                               int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;            // the CTA's keys
  float* sV = sK + TILE;
  float* sQ = sV + TILE;       // the streamed query tile, split
  float* sO = sQ + TILE;
  const size_t base = (size_t)blockIdx.x * n * DH;
  const int kt = blockIdx.y;   // key tile 0 (the most query tiles) first
  const int k0 = kt * BT;
  const int tiles = (n + BT - 1) / BT;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  load_tile(sK, k + base, k0, n, tid);
  load_tile(sV, v + base, k0, n, tid);

  float acc_k[DH / 8][4] = {}, acc_v[DH / 8][4] = {};
  const float* wK = sK + 16 * warp * LD;
  const float* wV = sV + 16 * warp * LD;
  const int key0 = k0 + 16 * warp;
  // the query tiles from the last down to the diagonal: the small terms
  // (dO' = dO / c) first, so the tensor core's truncated sums stay small
  for (int qt = tiles - 1; qt >= kt; --qt) {
    load_tile(sQ, q + base, qt * BT, n, tid);
    load_tile(sO, dO + base, qt * BT, n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_stage(sQ, tid);
    __syncthreads();
    const int q0 = qt * BT;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = 8 * PASS * p;  // the pass's first query of the tile
      if (qt != kt) {
        dkv_pass<false>(acc_k, acc_v, wK, wV, sQ + off * LD, sO + off * LD, g, t, key0,
                        q0 + off, 0, scale);
      } else {  // groups wholly before the warp's first key are skipped
        const int jlo = max(2 * warp - PASS * p, 0);
        if (jlo < PASS)
          dkv_pass<true>(acc_k, acc_v, wK, wV, sQ + off * LD, sO + off * LD, g, t, key0,
                         q0 + off, jlo, scale);
      }
    }
    __syncthreads();  // the stage is free for the next tile
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + g + 8 * h;
    if (key >= n) continue;
    float* dkr = dk + base + (size_t)key * DH + 2 * t;
    float* dvr = dv + base + (size_t)key * DH + 2 * t;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      *reinterpret_cast<float2*>(dkr + 8 * c) =
          make_float2(acc_k[c][2 * h] * scale, acc_k[c][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * c) = make_float2(acc_v[c][2 * h], acc_v[c][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
gated_attention_bwd_dq_kernel(const float* __restrict__ q,   // [BH, n, 64]
                              const float* __restrict__ k,   // [BH, n, 64]
                              const float* __restrict__ v,   // [BH, n, 64]
                              const float* __restrict__ dO,  // [BH, n, 64]
                              float* __restrict__ dq,        // [BH, n, 64]
                              int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;            // the CTA's queries
  float* sO = sQ + TILE;       // their dO (not yet divided by c)
  float* sK = sO + TILE;       // the streamed key tile, split
  float* sV = sK + TILE;
  const size_t base = (size_t)blockIdx.x * n * DH;
  const int tiles = (n + BT - 1) / BT;
  const int qt = tiles - 1 - blockIdx.y;  // the last query tile (the most key tiles) first
  const int q0 = qt * BT;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  load_tile(sQ, q + base, q0, n, tid);
  load_tile(sO, dO + base, q0, n, tid);

  const int row0 = q0 + 16 * warp;
  const float rc[2] = {1.0f / (float)(row0 + g + 1), 1.0f / (float)(row0 + g + 9)};
  float acc[DH / 8][4] = {};
  const float* wQ = sQ + 16 * warp * LD;
  const float* wO = sO + 16 * warp * LD;
  for (int kt = 0; kt <= qt; ++kt) {
    load_tile(sK, k + base, kt * BT, n, tid);
    load_tile(sV, v + base, kt * BT, n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_stage(sK, tid);
    __syncthreads();
    const int k0 = kt * BT;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = 8 * PASS * p;  // the pass's first key of the tile
      if (kt != qt) {
        dq_pass<false>(acc, wQ, wO, sK + off * LD, sV + off * LD, g, t, row0, k0 + off,
                       PASS - 1, rc, scale);
      } else {  // groups wholly after the warp's last query are skipped
        const int jhi = min(2 * warp + 1 - PASS * p, PASS - 1);
        if (jhi >= 0)
          dq_pass<true>(acc, wQ, wO, sK + off * LD, sV + off * LD, g, t, row0, k0 + off,
                        jhi, rc, scale);
      }
    }
    __syncthreads();  // the stage is free for the next tile
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    float* dqr = dq + base + (size_t)row * DH + 2 * t;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<float2*>(dqr + 8 * c) =
          make_float2(acc[c][2 * h] * scale, acc[c][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------- wide heads
// dh = D in {128, 256}: the same two kernels, templated on D, on SR, the
// rows of a streamed tile (32 at D = 128, 16 at D = 256; a pass is one
// streamed tile, SR / 8 groups), and on SL, the output columns a CTA
// writes (blockIdx.z picks the slice); S and dW are reduced over the whole
// D, once a slice.

// Rows row0 .. row0 + R - 1 of a [n, D] matrix into a staged tile of
// stride D + 8 (zeros past n).
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int n,
                                          int tid) {
  constexpr int LDW = D + 8;
#pragma unroll
  for (int i = 0; i < R * D / 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / (D / 4), c = 4 * (e % (D / 4));
    const bool in = row0 + r < n;
    cp_async16(dst + r * LDW + c, src + (size_t)(in ? row0 + r : 0) * D + c, in);
  }
}

// split_stage for two streamed tiles of SR rows: small parts 2 SR (D + 8)
// floats on.
template <int D, int SR>
__device__ __forceinline__ void split_rows(float* p, int tid) {
  constexpr int LDW = D + 8, STR = SR * LDW;
#pragma unroll
  for (int i = 0; i < 2 * SR * D / 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int m = e / (SR * D / 4), r = (e / (D / 4)) % SR, c = 4 * (e % (D / 4));
    float* x = p + m * STR + r * LDW + c;
    const float4 v = *reinterpret_cast<const float4*>(x);
    uint4 big, sml;
    split(v.x, big.x, sml.x);
    split(v.y, big.y, sml.y);
    split(v.z, big.z, sml.z);
    split(v.w, big.w, sml.w);
    *reinterpret_cast<uint4*>(x) = big;
    *reinterpret_cast<uint4*>(x + 2 * STR) = sml;
  }
}

template <int LDW>
__device__ __forceinline__ void a_frag_w(const float* p, int ks, int g, int t,
                                         uint32_t (&big)[4], uint32_t (&sml)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(p + g * LDW + 8 * ks + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(p + (g + 8) * LDW + 8 * ks + 2 * t);
  split(lo.x, big[0], sml[0]);
  split(hi.x, big[1], sml[1]);
  split(lo.y, big[2], sml[2]);
  split(hi.y, big[3], sml[3]);
}

// kstep with P groups, stride LDW and the small part SM floats on.
template <int P, int LDW, int SM, bool EDGE>
__device__ __forceinline__ void kstep_w(float (&acc)[P][4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4], const float* p, int jlo,
                                        int jhi) {
  uint2 bb[P], bs[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (EDGE && (j < jlo || j > jhi)) continue;
    bb[j] = ld2(p + 8 * j * LDW);
    bs[j] = ld2(p + SM + 8 * j * LDW);
  }
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], as, bb[j].x, bb[j].y);
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], ab, bs[j].x, bs[j].y);
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (!EDGE || (j >= jlo && j <= jhi)) mma(acc[j], ab, bb[j].x, bb[j].y);
}

// scores over the whole D: S's products, then dW's, each k-step.
template <int D, int SR, bool EDGE>
__device__ __forceinline__ void scores_w(float (&s)[SR / 8][4], float (&w)[SR / 8][4],
                                         const float* X, const float* U, const float* Y,
                                         const float* Z, int g, int t, int jlo, int jhi) {
  constexpr int P = SR / 8, LDW = D + 8, SM = 2 * SR * LDW;
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = w[j][e] = 0.0f;
  const int br = b_row(g) * LDW + 2 * t;
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ab[4], as[4];
    a_frag_w<LDW>(X, ks, g, t, ab, as);
    kstep_w<P, LDW, SM, EDGE>(s, ab, as, Y + br + 8 * ks, jlo, jhi);
    a_frag_w<LDW>(U, ks, g, t, ab, as);
    kstep_w<P, LDW, SM, EDGE>(w, ab, as, Z + br + 8 * ks, jlo, jhi);
  }
}

// accumulate over one 8-row group into an SL-column slice: p points at the
// group's first row, at the slice's first column.
template <int LDW, int SM, int SL>
__device__ __forceinline__ void accumulate_w(float (&acc)[SL / 8][4], const float (&c)[4],
                                             const float* p, int g, int t) {
  uint32_t ab[4], as[4];
  c_as_a(c, ab, as);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(p + lo_row(t) * LDW + g);
  const uint32_t* hi = reinterpret_cast<const uint32_t*>(p + hi_row(t) * LDW + g);
#pragma unroll
  for (int n0 = 0; n0 < SL / 8; n0 += 4) {
    uint32_t yb[4][2], ys[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      yb[n][0] = lo[8 * (n0 + n)];
      yb[n][1] = hi[8 * (n0 + n)];
      ys[n][0] = lo[SM + 8 * (n0 + n)];
      ys[n][1] = hi[SM + 8 * (n0 + n)];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], as, yb[n][0], yb[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], ab, ys[n][0], ys[n][1]);
#pragma unroll
    for (int n = 0; n < 4; ++n) mma(acc[n0 + n], ab, yb[n][0], yb[n][1]);
  }
}

// One pass of the wide dkv: the warp's keys against the SR queries from
// qp0; col0 the slice's first column.
template <int D, int SR, int SL, bool DIAG>
__device__ __forceinline__ void dkv_pass_w(float (&dk)[SL / 8][4],
                                           float (&dv)[SL / 8][4], const float* sK,
                                           const float* sV, const float* sQ, const float* sO,
                                           int g, int t, int key0, int qp0, int jlo, int col0,
                                           float scale) {
  constexpr int P = SR / 8, LDW = D + 8, SM = 2 * SR * LDW;
  float s[P][4], w[P][4];
  scores_w<D, SR, DIAG>(s, w, sK, sV, sQ, sO, g, t, jlo, P - 1);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (DIAG && j < jlo) continue;
    const int qlo = qp0 + 8 * j + lo_row(t), qhi = qp0 + 8 * j + hi_row(t);
    const float rc[2] = {1.0f / (float)(qlo + 1), 1.0f / (float)(qhi + 1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = (e & 1) ? qhi : qlo;
      const int key = key0 + g + 8 * (e >> 1);
      float gw, gd;
      gelu_and_grad(s[j][e] * scale, gw, gd);
      const bool live = !DIAG || key <= query;
      s[j][e] = live ? gw * rc[e & 1] : 0.0f;
      w[j][e] = live ? w[j][e] * rc[e & 1] * gd : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (DIAG && j < jlo) continue;
    accumulate_w<LDW, SM, SL>(dv, s[j], sO + 8 * j * LDW + col0, g, t);
    accumulate_w<LDW, SM, SL>(dk, w[j], sQ + 8 * j * LDW + col0, g, t);
  }
}

// One pass of the wide dq: the warp's queries against the SR keys from kp0.
template <int D, int SR, int SL, bool DIAG>
__device__ __forceinline__ void dq_pass_w(float (&dq)[SL / 8][4], const float* sQ,
                                          const float* sO, const float* sK, const float* sV,
                                          int g, int t, int row0, int kp0, int jhi, int col0,
                                          const float (&rc)[2], float scale) {
  constexpr int P = SR / 8, LDW = D + 8, SM = 2 * SR * LDW;
  float s[P][4], w[P][4];
  scores_w<D, SR, DIAG>(s, w, sQ, sO, sK, sV, g, t, 0, jhi);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (DIAG && j > jhi) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kp0 + 8 * j + ((e & 1) ? hi_row(t) : lo_row(t));
      const int row = row0 + g + 8 * (e >> 1);
      float gw, gd;
      gelu_and_grad(s[j][e] * scale, gw, gd);
      const bool live = !DIAG || key <= row;
      w[j][e] = live ? w[j][e] * rc[e >> 1] * gd : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (DIAG && j > jhi) continue;
    accumulate_w<LDW, SM, SL>(dq, w[j], sK + 8 * j * LDW + col0, g, t);
  }
}

template <int D, int SR>
constexpr int wide_smem_bytes() {  // the own two tiles, the streamed two big and small
  return (2 * BT + 4 * SR) * (D + 8) * (int)sizeof(float);
}

template <int D, int SR, int SL>
__global__ void __launch_bounds__(THREADS, 1)
gated_attention_bwd_dkv_wide_kernel(const float* __restrict__ q,   // [BH, n, D]
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dO,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int n, float scale) {
  constexpr int LDW = D + 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;               // the CTA's 64 keys, all D columns
  float* sV = sK + BT * LDW;
  float* sQ = sV + BT * LDW;      // the streamed SR queries, split
  float* sO = sQ + SR * LDW;
  const size_t base = (size_t)blockIdx.x * n * D;
  const int k0 = blockIdx.y * BT;  // key tile 0 (the most query tiles) first
  const int col0 = SL * blockIdx.z;
  const int tiles = (n + SR - 1) / SR;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  load_rows<D, BT>(sK, k + base, k0, n, tid);
  load_rows<D, BT>(sV, v + base, k0, n, tid);

  float acc_k[SL / 8][4] = {}, acc_v[SL / 8][4] = {};
  const float* wK = sK + 16 * warp * LDW;
  const float* wV = sV + 16 * warp * LDW;
  const int key0 = k0 + 16 * warp;
  // the query tiles from the last down to the first at or past k0: the
  // small terms first, as at dh = 64
  for (int qt = tiles - 1; qt >= k0 / SR; --qt) {
    const int q0 = qt * SR;
    load_rows<D, SR>(sQ, q + base, q0, n, tid);
    load_rows<D, SR>(sO, dO + base, q0, n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_rows<D, SR>(sQ, tid);
    __syncthreads();
    if (q0 >= k0 + BT) {
      dkv_pass_w<D, SR, SL, false>(acc_k, acc_v, wK, wV, sQ, sO, g, t, key0, q0, 0, col0, scale);
    } else {  // groups wholly before the warp's first key are skipped
      const int jlo = max((key0 - q0) / 8, 0);
      if (jlo < SR / 8)
        dkv_pass_w<D, SR, SL, true>(acc_k, acc_v, wK, wV, sQ, sO, g, t, key0, q0, jlo, col0,
                                scale);
    }
    __syncthreads();  // the stage is free for the next tile
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + g + 8 * h;
    if (key >= n) continue;
    float* dkr = dk + base + (size_t)key * D + col0 + 2 * t;
    float* dvr = dv + base + (size_t)key * D + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < SL / 8; ++c) {
      *reinterpret_cast<float2*>(dkr + 8 * c) =
          make_float2(acc_k[c][2 * h] * scale, acc_k[c][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dvr + 8 * c) = make_float2(acc_v[c][2 * h], acc_v[c][2 * h + 1]);
    }
  }
}

template <int D, int SR, int SL>
__global__ void __launch_bounds__(THREADS, 1)
gated_attention_bwd_dq_wide_kernel(const float* __restrict__ q,   // [BH, n, D]
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dO,
                                   float* __restrict__ dq, int n, float scale) {
  constexpr int LDW = D + 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // the CTA's 64 queries, all D columns
  float* sO = sQ + BT * LDW;      // their dO (not yet divided by c)
  float* sK = sO + BT * LDW;      // the streamed SR keys, split
  float* sV = sK + SR * LDW;
  const size_t base = (size_t)blockIdx.x * n * D;
  const int q0 = ((n + BT - 1) / BT - 1 - (int)blockIdx.y) * BT;  // the last tile first
  const int col0 = SL * blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  load_rows<D, BT>(sQ, q + base, q0, n, tid);
  load_rows<D, BT>(sO, dO + base, q0, n, tid);

  const int row0 = q0 + 16 * warp;
  const float rc[2] = {1.0f / (float)(row0 + g + 1), 1.0f / (float)(row0 + g + 9)};
  float acc[SL / 8][4] = {};
  const float* wQ = sQ + 16 * warp * LDW;
  const float* wO = sO + 16 * warp * LDW;
  // the key tiles from the first up to the CTA's last query
  for (int k0 = 0; k0 < q0 + BT && k0 < n; k0 += SR) {
    load_rows<D, SR>(sK, k + base, k0, n, tid);
    load_rows<D, SR>(sV, v + base, k0, n, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_rows<D, SR>(sK, tid);
    __syncthreads();
    if (k0 + SR <= q0) {
      dq_pass_w<D, SR, SL, false>(acc, wQ, wO, sK, sV, g, t, row0, k0, SR / 8 - 1, col0, rc, scale);
    } else if (row0 + 15 >= k0) {  // groups wholly after the warp's last query are skipped
      const int jhi = min((row0 + 15 - k0) / 8, SR / 8 - 1);
      dq_pass_w<D, SR, SL, true>(acc, wQ, wO, sK, sV, g, t, row0, k0, jhi, col0, rc, scale);
    }
    __syncthreads();  // the stage is free for the next tile
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    float* dqr = dq + base + (size_t)row * D + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < SL / 8; ++c)
      *reinterpret_cast<float2*>(dqr + 8 * c) =
          make_float2(acc[c][2 * h] * scale, acc[c][2 * h + 1] * scale);
  }
}

template <int D, int SR, int SL>
int launch_dkv_wide(const float* q, const float* k, const float* v, const float* dO, float* dk,
                    float* dv, int BH, int n, float scale, cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<D, SR>();
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dkv_wide_kernel<D, SR, SL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT, D / SL);
  gated_attention_bwd_dkv_wide_kernel<D, SR, SL><<<grid, THREADS, smem, stream>>>(
      q, k, v, dO, dk, dv, n, scale);
  return (int)cudaGetLastError();
}

template <int D, int SR, int SL>
int launch_dq_wide(const float* q, const float* k, const float* v, const float* dO, float* dq,
                   int BH, int n, float scale, cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<D, SR>();
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dq_wide_kernel<D, SR, SL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT, D / SL);
  gated_attention_bwd_dq_wide_kernel<D, SR, SL><<<grid, THREADS, smem, stream>>>(
      q, k, v, dO, dq, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dK and dV of the gradient (q, k, v, dO all [BH, n, 64]).
extern "C" int gated_attention_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                              const float* dO, float* dk, float* dv, int BH,
                                              int n, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT);
  gated_attention_bwd_dkv_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(q, k, v, dO, dk, dv, n,
                                                                        scale);
  return (int)cudaGetLastError();
}

// dQ of the gradient.
extern "C" int gated_attention_bwd_dq_launch(const float* q, const float* k, const float* v,
                                             const float* dO, float* dq, int BH, int n,
                                             float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT);
  gated_attention_bwd_dq_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(q, k, v, dO, dq, n,
                                                                       scale);
  return (int)cudaGetLastError();
}

// dK and dV at dh in {128, 256} (q, k, v, dO all [BH, n, dh]); any other dh
// is refused with cudaErrorInvalidValue.
extern "C" int gated_attention_bwd_wide_dkv_launch(const float* q, const float* k,
                                                   const float* v, const float* dO, float* dk,
                                                   float* dv, int BH, int n, int dh, float scale,
                                                   cudaStream_t stream) {
  if (dh == 128) return launch_dkv_wide<128, 32, 128>(q, k, v, dO, dk, dv, BH, n, scale, stream);
  if (dh == 256) return launch_dkv_wide<256, 16, 128>(q, k, v, dO, dk, dv, BH, n, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// dQ at dh in {128, 256}.
extern "C" int gated_attention_bwd_wide_dq_launch(const float* q, const float* k, const float* v,
                                                  const float* dO, float* dq, int BH, int n,
                                                  int dh, float scale, cudaStream_t stream) {
  if (dh == 128) return launch_dq_wide<128, 32, 128>(q, k, v, dO, dq, BH, n, scale, stream);
  if (dh == 256) return launch_dq_wide<256, 16, 128>(q, k, v, dO, dq, BH, n, scale, stream);
  return (int)cudaErrorInvalidValue;
}
