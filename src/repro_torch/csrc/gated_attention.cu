// Hand-written Hopper (sm_90a) kernel of causal sigma (GELU-gated) attention,
// on the tensor cores in 3xTF32.
//
// Replaces the TPU Pallas kernel of
// src/repro/kernels/gated_attention/gated_attention.py: gated_attention_kernel
// (pallas_call at :90). For every (batch*head) bh and query row i < nq:
//   O[bh,i,:] = sum_{j <= i, j < nk} gelu(q[bh,i] . k[bh,j] * scale) v[bh,j,:]
//               / min(i + 1, nk)
// (paper eq. 1 with the count normalisation of repro/models/attention.py).
//
// Instantiated for dh = dv = 64 (VQ-OPT, stablelm, internvl2, musicgen), 128
// (phi4-mini) and 256 (gemma3's global layers); the launcher takes dh.
//
// What bounds it on an H100: operations. At the VQ-OPT forward's shapes
// (BH = 48, n = 1024, dh = dv = 64) the causal half is 48 x 524,800 (query, key) pairs
// x 256 flops = 6.45 GFLOP: 0.0962 ms at the 67 TFLOP/s of the FP32 CUDA
// cores, and, as three TF32 products each, 0.0391 ms at the tensor cores'
// 495 TFLOP/s. q, k, v and O are 50.3 MB, 0.015 ms at 3.35 TB/s.
//
// The route (tf32_mma.cuh, shared with the backward): mma.sync.m16n8k8
// TF32 products with FP32 accumulation, each f32 operand x split as big =
// x rounded to TF32 (to nearest, ties away) and small = x - big (exact;
// the tensor core reads its top 19 bits), each product taken as
// small*big + big*small + big*big. That keeps ~21 bits of
// the operands, enough for the reference's 1e-5 f32 bound, which one TF32
// product (~11 bits) misses.
//
// The design:
// * One CTA of 4 warps per (64-row q tile, bh); each warp owns 16 query
//   rows. The grid's slow axis walks the q tiles from the last: a tile does
//   work in proportion to its index, so the long tiles start in the first
//   wave and the short ones fill the tail.
// * Each warp loads its 16 x 64 q rows once into registers as A fragments
//   (32 registers) and splits them per k-step.
// * k and v come in 64-key tiles through a double-buffered ring of 16-byte
//   cp.async copies into padded shared memory (k rows 72 floats, v rows 68:
//   no fragment load hits a bank twice); tile t + 1 is in flight while tile
//   t is used. No tile above the CTA's diagonal is loaded, and a warp skips
//   the 8-key groups above its own last row.
// * A tile goes in two passes of 32 keys. S = q k^T: per k-step, the k
//   fragments of the pass's 4 key groups are loaded and split, then each of
//   the three products runs over the 4 groups in turn, so 4 independent
//   MMAs stand between two into one accumulator. Inside each 8-wide k-step
//   the head dims are renumbered (A column t <-> dim 2t, t + 4 <-> 2t + 1),
//   so a k fragment is one 8-byte shared load. Each warp splits its own k
//   and v fragments.
// * W = gelu(scale S) in registers for the whole pass (the port's tanh
//   GELU, common.cuh), the causal / ragged mask applied only in a tile that
//   holds a key past one of the warp's rows or past nk; other tiles run a
//   copy of the loops without mask or branch.
// * O += W v: the S accumulator of a key group is the A fragment of W as it
//   stands. The C layout gives a thread keys (2t, 2t + 1), the A layout wants
//   columns (t, t + 4), so the keys of each 8-key step are renumbered the same
//   way and v's B fragment rows read in that order (as FlashAttention-2
//   does): no shuffle and no trip through shared memory. There is no
//   softmax, so no running max and no rescale.
// * Epilogue: each row divided by min(i + 1, nk); a shuffle between lane
//   pairs gives each thread 4 consecutive columns, written as float4. Rows
//   >= nq write nothing. No atomics: every sum runs in a fixed order, so two
//   calls give the same bits.
// * Wider heads (dh = 128, 256). The dh = 64 design does not scale: q's
//   fragments and the output accumulator take dh / 2 registers a thread
//   each (216 registers at dh = 64), and a double-buffered 64-key stage at
//   dh = 256 needs 268 KB of shared memory. So q's 64 x dh tile is staged
//   once in shared memory (rows padded to dh + 8 floats, like k's:
//   conflict-free 8-byte fragment loads) and read per k-step, the key tile
//   shrinks to 32, and each CTA accumulates at most 128 output columns (a
//   64-register accumulator; the W v loop takes them 8 column groups at a
//   time). At dh = 256 a third grid axis splits dv into two 128-column
//   chunks, each CTA computing S over the full dh: per (query, key) pair
//   3 dh multiply-adds where 2 dh are needed. Shared memory a CTA: 103 KB
//   at dh = 128 (two CTAs an SM), 169 KB at dh = 256 (one); 197 and 255
//   registers, no spills. With 64-column chunks (S recomputed 2x and 4x)
//   the same shapes took 2.91 and 4.34 ms (below).
//
// Measured (chip_smoke.py --sweep, NVIDIA H100 80GB HBM3, 700.00 W; device
// ms by kernel name): BH = 48 at n = 37 / 128 / 256 / 512 / 1000 / 1024 /
// 2048: 0.0083 / 0.0125 / 0.0239 / 0.0465 / 0.1454 / 0.1460 / 0.5156 (the
// previous FP32-core kernel 0.0115 / 0.0229 / 0.0600 / 0.1458 / 0.4727 /
// 0.4783 / 1.5661 in the same run); BH = 12, n = 1024: 0.0678 (0.2253);
// nq x nk = 1024 x 512: 0.1141 (0.3058), 512 x 1024: 0.0471 (0.1461). Below
// plain everywhere, within 1.1e-6 of it. At n = 1024 that is 3.7x the
// 3xTF32 bound and 1.5x the FP32-core bound. What holds it: the MMAs
// themselves (mma.sync runs TF32 at about half the 495 TFLOP/s that wgmma
// reaches: dropping two of the three products takes 0.146 to 0.089 ms),
// then the GELUs (0.029 ms) and the big / small splits (0.022 ms), which
// overlap the MMAs only in part at two CTAs (8 warps) an SM: 216 registers,
// no spills, 70 KB of shared memory a CTA.
//
// Wide heads (chip_smoke.py --sweep, same card, device ms; 64-column chunks
// in the same call in parentheses): dh = 128, BH = 24 at n = 4096 / 1000:
// 1.8457 / 0.1489 (2.9130 / 0.2191), 2.95x its 0.6249 ms 3xTF32 bound at
// 4096, plain 8.3705 / 0.5669; dh = 256, BH = 16 at n = 3072 / 1000:
// 2.6785 / 0.3781 (4.3395 / 0.5852), 5.7x its 0.4687 ms bound at 3072,
// plain 4.7410 / 0.5526. dh = 64 is now a template instance: its machine
// code differs from the untemplated kernel's (216 registers), and its
// 0.1479 ms at n = 1024 is within noise of the untemplated kernel's time
// in the same run.
//
// Plain C interface, loaded with ctypes; the launcher returns the CUDA error
// code so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "patch_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using repro_torch::gelu_tanh;
using repro_torch::patch_tile::cp_async16;
using repro_torch::patch_tile::cp_async_commit;
using repro_torch::patch_tile::cp_async_wait;
using repro_torch::tf32::mma;
using repro_torch::tf32::split;

constexpr int BQ = 64;              // query rows a CTA
constexpr int JH = 4;               // 8-key groups a pass takes (S, then W v)
constexpr int WARPS = BQ / 16;      // 16 query rows a warp
constexpr int THREADS = 32 * WARPS;

// One instantiation: head dim DH of q and k (v has DH columns too, DV of
// them a CTA) and BK keys a staged tile. At DH = 64 q's A fragments stay in
// registers; wider heads read them from a staged q tile at each k-step.
template <int DH_, int BK_, int DV_>
struct Shape {
  static constexpr int DH = DH_;
  static constexpr int BK = BK_;
  static constexpr int DV = DV_;
  static constexpr bool Q_REGS = DH == 64;
  static constexpr int KS = DH + 8;  // padded stride of a staged k (and q) row
  static constexpr int VS = DV + 4;  // padded stride of a staged v row
  static constexpr int K_FLOATS = BK * KS;
  static constexpr int STAGE_FLOATS = K_FLOATS + BK * VS;
  static constexpr int Q_FLOATS = Q_REGS ? 0 : BQ * KS;
  static constexpr int SMEM_BYTES = (2 * STAGE_FLOATS + Q_FLOATS) * (int)sizeof(float);
};

// q's A fragments held in registers (a one-element stand-in where q is staged)
template <class S>
using QRegs = float[S::Q_REGS ? S::DH / 8 : 1][4];

// Keys k0 .. k0 + BK - 1 of k (all DH columns) and v (the CTA's DV
// columns: vb points at the first) into one stage (zeros past nk).
template <class S>
__device__ __forceinline__ void load_tile(float* stage, const float* kb, const float* vb,
                                          int k0, int nk, int tid) {
  float* sk = stage;
  float* sv = stage + S::K_FLOATS;
  if constexpr (S::DH == S::DV) {  // k and v rows of one width: one loop
#pragma unroll
    for (int i = 0; i < S::BK * S::DV / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (S::DV / 4), c = 4 * (e % (S::DV / 4));
      const bool in = k0 + r < nk;
      const size_t off = (size_t)(in ? k0 + r : 0) * S::DV + c;
      cp_async16(sk + r * S::KS + c, kb + off, in);
      cp_async16(sv + r * S::VS + c, vb + off, in);
    }
  } else {
#pragma unroll
    for (int i = 0; i < S::BK * S::DH / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (S::DH / 4), c = 4 * (e % (S::DH / 4));
      const bool in = k0 + r < nk;
      cp_async16(sk + r * S::KS + c, kb + (size_t)(in ? k0 + r : 0) * S::DH + c, in);
    }
#pragma unroll
    for (int i = 0; i < S::BK * S::DV / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (S::DV / 4), c = 4 * (e % (S::DV / 4));
      const bool in = k0 + r < nk;
      cp_async16(sv + r * S::VS + c, vb + (size_t)(in ? k0 + r : 0) * S::DH + c, in);
    }
  }
}

// acc += gelu(scale q k^T) v over one BK-key tile staged at sk, sv, for the
// warp's 16 query rows from r0 (q as A fragments in qf, or staged from
// sq, the warp's row g), JH 8-key groups a pass. EDGE: the tile holds a
// key past one of those rows or past nk, so the scores are masked and the
// 8-key groups past the warp's last key (jn the last it attends) are
// skipped; elsewhere the loops hold no branch.
template <class S, bool EDGE>
__device__ __forceinline__ void tile_product(float (&acc)[S::DV / 8][4], const QRegs<S>& qf,
                                             const float* sq, const float* sk,
                                             const float* sv, int g, int t, int r0, int k0,
                                             int nk, int jn, float scale) {
#pragma unroll
  for (int j0 = 0; j0 < S::BK / 8; j0 += JH) {
    if (EDGE && j0 > jn) break;
    float s[JH][4];
#pragma unroll
    for (int j = 0; j < JH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;

    // S = q k^T in 3xTF32: small * big, big * small, then big * big, each
    // over the pass's key groups in turn (JH independent MMAs between two
    // into one accumulator)
#pragma unroll
    for (int ks = 0; ks < S::DH / 8; ++ks) {
      float qa[4];
      if constexpr (S::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
      } else {  // rows g and g + 8, dims 2t and 2t + 1 (the A layout's order)
        const float2 lo = *reinterpret_cast<const float2*>(sq + 8 * ks + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(sq + 8 * S::KS + 8 * ks + 2 * t);
        qa[0] = lo.x;
        qa[1] = hi.x;
        qa[2] = lo.y;
        qa[3] = hi.y;
      }
      uint32_t qbig[4], qsml[4], kbig[JH][2], ksml[JH][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qa[e], qbig[e], qsml[e]);
#pragma unroll
      for (int j = 0; j < JH; ++j) {
        if (EDGE && j0 + j > jn) continue;
        const float2 kk = *reinterpret_cast<const float2*>(
            sk + (8 * (j0 + j) + g) * S::KS + 8 * ks + 2 * t);
        split(kk.x, kbig[j][0], ksml[j][0]);
        split(kk.y, kbig[j][1], ksml[j][1]);
      }
#pragma unroll
      for (int j = 0; j < JH; ++j)
        if (!EDGE || j0 + j <= jn) mma(s[j], qsml, kbig[j][0], kbig[j][1]);
#pragma unroll
      for (int j = 0; j < JH; ++j)
        if (!EDGE || j0 + j <= jn) mma(s[j], qbig, ksml[j][0], ksml[j][1]);
#pragma unroll
      for (int j = 0; j < JH; ++j)
        if (!EDGE || j0 + j <= jn) mma(s[j], qbig, kbig[j][0], kbig[j][1]);
    }

    // W = gelu(scale S) for all the pass's key groups (independent GELUs)
#pragma unroll
    for (int j = 0; j < JH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e / 2);
        const int key = k0 + 8 * (j0 + j) + 2 * t + (e % 2);
        s[j][e] = (!EDGE || (key <= row && key < nk)) ? gelu_tanh(s[j][e] * scale) : 0.0f;
      }

    // O += W v, key group j as the k-step (keys renumbered: A column t is
    // key 2t, column t + 4 key 2t + 1)
#pragma unroll
    for (int j = 0; j < JH; ++j) {
      if (EDGE && j0 + j > jn) continue;
      uint32_t wbig[4], wsml[4];
      split(s[j][0], wbig[0], wsml[0]);  // row g, key 2t
      split(s[j][2], wbig[1], wsml[1]);  // row g + 8, key 2t
      split(s[j][1], wbig[2], wsml[2]);  // row g, key 2t + 1
      split(s[j][3], wbig[3], wsml[3]);  // row g + 8, key 2t + 1
      const float* vr = sv + (8 * (j0 + j) + 2 * t) * S::VS + g;
      // 8 output column groups at a time: their v fragments split, then
      // the three products, each over the 8 groups in turn
#pragma unroll
      for (int n0 = 0; n0 < S::DV / 8; n0 += 8) {
        uint32_t vbig[8][2], vsml[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          split(vr[8 * (n0 + n)], vbig[n][0], vsml[n][0]);
          split(vr[S::VS + 8 * (n0 + n)], vbig[n][1], vsml[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) mma(acc[n0 + n], wsml, vbig[n][0], vbig[n][1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma(acc[n0 + n], wbig, vsml[n][0], vsml[n][1]);
#pragma unroll
        for (int n = 0; n < 8; ++n) mma(acc[n0 + n], wbig, vbig[n][0], vbig[n][1]);
      }
    }
  }
}

// The 64 query rows from q0 of one bh, output columns c0 .. c0 + DV - 1:
// qb and kb point at its q and k, vb and ob at column c0 of its v and O
// (rows DH floats apart).
template <class S>
__device__ __forceinline__ void attend_tile(const float* __restrict__ qb,
                                            const float* __restrict__ kb,
                                            const float* __restrict__ vb,
                                            float* __restrict__ ob, int q0, int nq, int nk,
                                            float scale, float* smem) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' group and thread-in-group
  const int r0 = q0 + 16 * warp;         // the warp's first query row

  // causal: no key after the tile's last row (nor past nk) is ever attended
  const int ntk = min(q0 + BQ - 1, nk - 1) / S::BK + 1;
  float* sq = smem + 2 * S::STAGE_FLOATS;  // the staged q tile (wide heads)
  if constexpr (!S::Q_REGS) {  // in the first copy group, with tile 0
#pragma unroll
    for (int i = 0; i < BQ * S::DH / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (S::DH / 4), c = 4 * (e % (S::DH / 4));
      const bool in = q0 + r < nq;
      cp_async16(sq + r * S::KS + c, qb + (size_t)(in ? q0 + r : 0) * S::DH + c, in);
    }
  }
  load_tile<S>(smem, kb, vb, 0, nk, tid);
  cp_async_commit();

  // DH = 64: q as A fragments (rows g and g + 8 of the warp's 16), head
  // dims renumbered inside each k-step: column t is dim 2t, column t + 4
  // dim 2t + 1. Split into big and small at each use.
  QRegs<S> qf;
  if constexpr (S::Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < S::DH / 8; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        const float2 x = row < nq
            ? *reinterpret_cast<const float2*>(qb + (size_t)row * S::DH + 8 * ks + 2 * t)
            : make_float2(0.0f, 0.0f);
        qf[ks][h] = x.x;
        qf[ks][2 + h] = x.y;
      }
    }
  }
  const float* sqw = sq + (16 * warp + g) * S::KS;  // the warp's row g, staged

  float acc[S::DV / 8][4];
#pragma unroll
  for (int j = 0; j < S::DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int warp_last = min(r0 + 15, nk - 1);  // the warp's last key
  for (int it = 0; it < ntk; ++it) {
    const int k0 = it * S::BK;
    if (it + 1 < ntk) {
      load_tile<S>(smem + ((it + 1) & 1) * S::STAGE_FLOATS, kb, vb, k0 + S::BK, nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = smem + (it & 1) * S::STAGE_FLOATS;
    const float* sv = sk + S::K_FLOATS;
    const int span = warp_last - k0;  // the warp attends keys k0 .. k0 + span
    if (k0 + S::BK - 1 <= r0 && k0 + S::BK <= nk)
      tile_product<S, false>(acc, qf, sqw, sk, sv, g, t, r0, k0, nk, S::BK / 8 - 1, scale);
    else if (span >= 0)
      tile_product<S, true>(acc, qf, sqw, sk, sv, g, t, r0, k0, nk,
                            min(span / 8, S::BK / 8 - 1), scale);
    __syncthreads();  // the stage is free for tile it + 2
  }

  // lane pairs swap halves: an even t writes row g, columns 2t .. 2t + 3 of
  // each 8-column group, an odd t row g + 8, columns 2t - 2 .. 2t + 1
  const bool odd = t % 2;
  const int row = r0 + g + (odd ? 8 : 0);
  const float cnt = (float)min(row + 1, nk);
  float* orow = ob + (size_t)row * S::DH + 2 * t - (odd ? 2 : 0);
#pragma unroll
  for (int nt = 0; nt < S::DV / 8; ++nt) {
    const float sx = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][0] : acc[nt][2], 1);
    const float sy = __shfl_xor_sync(0xffffffffu, odd ? acc[nt][1] : acc[nt][3], 1);
    float4 out = odd ? make_float4(sx, sy, acc[nt][2], acc[nt][3])
                     : make_float4(acc[nt][0], acc[nt][1], sx, sy);
    out.x /= cnt;
    out.y /= cnt;
    out.z /= cnt;
    out.w /= cnt;
    if (row < nq) *reinterpret_cast<float4*>(orow + 8 * nt) = out;
  }
}

template <class S>
__global__ void __launch_bounds__(THREADS)
gated_attention_kernel(const float* __restrict__ q,  // [BH, nq, DH]
                       const float* __restrict__ k,  // [BH, nk, DH]
                       const float* __restrict__ v,  // [BH, nk, DH]
                       float* __restrict__ o,        // [BH, nq, DH]
                       int nq, int nk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const size_t bh = blockIdx.x;
  const int c0 = blockIdx.z * S::DV;  // the CTA's output columns
  attend_tile<S>(q + bh * nq * S::DH, k + bh * nk * S::DH, v + bh * nk * S::DH + c0,
                 o + bh * nq * S::DH + c0,
                 (gridDim.y - 1 - blockIdx.y) * BQ,  // the heaviest tile first
                 nq, nk, scale, smem);
}

template <class S>
int launch(const float* q, const float* k, const float* v, float* o, int BH, int nq, int nk,
           float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gated_attention_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (nq + BQ - 1) / BQ, S::DH / S::DV);
  gated_attention_kernel<S><<<grid, THREADS, S::SMEM_BYTES, stream>>>(q, k, v, o, nq, nk,
                                                                       scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dh is the head dim of q, k and v: 64, 128 or 256 (cudaErrorInvalidValue
// for any other).
extern "C" int gated_attention_launch(const float* q, const float* k,
                                      const float* v, float* o, int BH, int nq,
                                      int nk, int dh, float scale,
                                      cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<Shape<64, 64, 64>>(q, k, v, o, BH, nq, nk, scale, stream);
    case 128:
      return launch<Shape<128, 32, 128>>(q, k, v, o, BH, nq, nk, scale, stream);
    case 256:
      return launch<Shape<256, 32, 128>>(q, k, v, o, BH, nq, nk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
