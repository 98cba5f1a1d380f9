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
// What bounds it on an H100: operations. At the forward's shapes (BH = 48,
// n = 1024, dh = dv = 64) the causal half is 48 x 524,800 (query, key) pairs
// x 256 flops = 6.45 GFLOP: 0.0962 ms at the 67 TFLOP/s of the FP32 CUDA
// cores, and, as three TF32 products each, 0.0391 ms at the tensor cores'
// 495 TFLOP/s. q, k, v and O are 50.3 MB, 0.015 ms at 3.35 TB/s.
//
// The route: mma.sync.m16n8k8 TF32 products with FP32 accumulation, each
// f32 operand x split as big = x rounded to TF32 (to nearest, ties away) and
// small = x - big (exact; the tensor core reads its top 19 bits), each
// product taken as small*big + big*small + big*big. That keeps ~21 bits of
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
// overlap the MMAs only in part at two CTAs (8 warps) an SM: 215 registers,
// no spills, 70 KB of shared memory a CTA.
//
// Plain C interface, loaded with ctypes; the launcher returns the CUDA error
// code so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "patch_tile.cuh"

namespace {

using repro_torch::gelu_tanh;
using repro_torch::patch_tile::cp_async16;
using repro_torch::patch_tile::cp_async_commit;
using repro_torch::patch_tile::cp_async_wait;

constexpr int DH = 64;              // head dim of q, k and v (dh == dv)
constexpr int BQ = 64;              // query rows a CTA
constexpr int BK = 64;              // keys a tile
constexpr int JH = 4;               // 8-key groups a pass takes (S, then W v)
constexpr int WARPS = BQ / 16;      // 16 query rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int KS = DH + 8;          // padded stride of a staged k row
constexpr int VS = DH + 4;          // padded stride of a staged v row
constexpr int K_FLOATS = BK * KS;
constexpr int STAGE_FLOATS = K_FLOATS + BK * VS;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * (int)sizeof(float);

// x as big + small TF32 operands: big rounded to TF32 (half an ulp added,
// the 13 low bits cleared), small the exact rest (the MMA reads its top 19
// bits).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  big = b;
  small = __float_as_uint(x - __uint_as_float(b));
}

// d += a b for one 16 x 8 x 8 TF32 tile (f32 accumulate).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Keys k0 .. k0 + BK - 1 of k and v into one stage (zeros past nk).
__device__ __forceinline__ void load_tile(float* stage, const float* kb, const float* vb,
                                          int k0, int nk, int tid) {
  float* sk = stage;
  float* sv = stage + K_FLOATS;
#pragma unroll
  for (int i = 0; i < BK * DH / 4 / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / (DH / 4), c = 4 * (e % (DH / 4));
    const bool in = k0 + r < nk;
    const size_t off = (size_t)(in ? k0 + r : 0) * DH + c;
    cp_async16(sk + r * KS + c, kb + off, in);
    cp_async16(sv + r * VS + c, vb + off, in);
  }
}

// acc += gelu(scale q k^T) v over one 64-key tile staged at sk, sv, for the
// warp's 16 query rows from r0 (q in qf as A fragments), JH 8-key groups a
// pass. EDGE: the tile holds a key past one of those rows or past nk, so
// the scores are masked and the 8-key groups past the warp's last key (jn
// the last it attends) are skipped; elsewhere the loops hold no branch.
template <bool EDGE>
__device__ __forceinline__ void tile_product(float (&acc)[DH / 8][4],
                                             const float (&qf)[DH / 8][4],
                                             const float* sk, const float* sv, int g, int t,
                                             int r0, int k0, int nk, int jn, float scale) {
#pragma unroll
  for (int j0 = 0; j0 < BK / 8; j0 += JH) {
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
    for (int ks = 0; ks < DH / 8; ++ks) {
      uint32_t qbig[4], qsml[4], kbig[JH][2], ksml[JH][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qf[ks][e], qbig[e], qsml[e]);
#pragma unroll
      for (int j = 0; j < JH; ++j) {
        if (EDGE && j0 + j > jn) continue;
        const float2 kk = *reinterpret_cast<const float2*>(
            sk + (8 * (j0 + j) + g) * KS + 8 * ks + 2 * t);
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
      const float* vr = sv + (8 * (j0 + j) + 2 * t) * VS + g;
      uint32_t vbig[DH / 8][2], vsml[DH / 8][2];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        split(vr[8 * n], vbig[n][0], vsml[n][0]);
        split(vr[VS + 8 * n], vbig[n][1], vsml[n][1]);
      }
      // the three products, each over the 8 output column groups in turn
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) mma(acc[n], wsml, vbig[n][0], vbig[n][1]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) mma(acc[n], wbig, vsml[n][0], vsml[n][1]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) mma(acc[n], wbig, vbig[n][0], vbig[n][1]);
    }
  }
}

// The 64 query rows from q0 of one bh: qb, kb, vb, ob point at its q, k, v
// and O.
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
  const int ntk = min(q0 + BQ - 1, nk - 1) / BK + 1;
  load_tile(smem, kb, vb, 0, nk, tid);
  cp_async_commit();

  // q as A fragments (rows g and g + 8 of the warp's 16), head dims
  // renumbered inside each k-step: column t is dim 2t, column t + 4 dim
  // 2t + 1. Split into big and small once per tile.
  float qf[DH / 8][4];
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      const float2 x = row < nq
          ? *reinterpret_cast<const float2*>(qb + (size_t)row * DH + 8 * ks + 2 * t)
          : make_float2(0.0f, 0.0f);
      qf[ks][h] = x.x;
      qf[ks][2 + h] = x.y;
    }
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int warp_last = min(r0 + 15, nk - 1);  // the warp's last key
  for (int it = 0; it < ntk; ++it) {
    const int k0 = it * BK;
    if (it + 1 < ntk) {
      load_tile(smem + ((it + 1) & 1) * STAGE_FLOATS, kb, vb, k0 + BK, nk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = smem + (it & 1) * STAGE_FLOATS;
    const float* sv = sk + K_FLOATS;
    const int span = warp_last - k0;  // the warp attends keys k0 .. k0 + span
    if (k0 + BK - 1 <= r0 && k0 + BK <= nk)
      tile_product<false>(acc, qf, sk, sv, g, t, r0, k0, nk, BK / 8 - 1, scale);
    else if (span >= 0)
      tile_product<true>(acc, qf, sk, sv, g, t, r0, k0, nk, min(span / 8, BK / 8 - 1), scale);
    __syncthreads();  // the stage is free for tile it + 2
  }

  // lane pairs swap halves: an even t writes row g, columns 2t .. 2t + 3 of
  // each 8-column group, an odd t row g + 8, columns 2t - 2 .. 2t + 1
  const bool odd = t % 2;
  const int row = r0 + g + (odd ? 8 : 0);
  const float cnt = (float)min(row + 1, nk);
  float* orow = ob + (size_t)row * DH + 2 * t - (odd ? 2 : 0);
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
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

__global__ void __launch_bounds__(THREADS)
gated_attention_kernel(const float* __restrict__ q,  // [BH, nq, DH]
                       const float* __restrict__ k,  // [BH, nk, DH]
                       const float* __restrict__ v,  // [BH, nk, DH]
                       float* __restrict__ o,        // [BH, nq, DH]
                       int nq, int nk, float scale) {
  extern __shared__ __align__(16) float smem[];
  const size_t bh = blockIdx.x;
  attend_tile(q + bh * nq * DH, k + bh * nk * DH, v + bh * nk * DH, o + bh * nq * DH,
              (gridDim.y - 1 - blockIdx.y) * BQ,  // the heaviest tile first
              nq, nk, scale, smem);
}

}  // namespace

extern "C" int gated_attention_launch(const float* q, const float* k,
                                      const float* v, float* o, int BH, int nq,
                                      int nk, float scale,
                                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gated_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (nq + BQ - 1) / BQ);
  gated_attention_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(q, k, v, o, nq, nk, scale);
  return (int)cudaGetLastError();
}
