// Hand-written Hopper (sm_90a) kernels of the fused incremental edit step.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/fused_step/fused_step.py:
//   fused_step_kernel          fused_step_kernel / fused_step_kernel_batched
//                              (fused_step.py:82 and :143, pallas_call at :114
//                              and :179): per layer, the masked
//                              old-minus/new-plus attention column patch, the
//                              T accumulate and the score-space requantize;
//   delta_gate_kernel          delta_gate_kernel (fused_step.py:218,
//                              pallas_call at :242): the sigma-delta gate.
//
// fused_step computes, for every document b, row i and vq head hh over its
// g = H / hq attention heads h = hh*g + j (the head order fixed by the
// engine's cb_per_head reshape):
//   T[b,i,h,:] = T_base[b,i,h,:]
//              + (sum_c m[b,i,c] gelu(s q.k_new[b,h,c]) vc_new[b,h,c,:]
//                 - sum_c m[b,i,c] gelu(s q.k_old[b,h,c]) vc_old[b,h,c,:])
//   codes[b,i,hh] = argmax_Q(sum_j T[b,i,hh*g+j,:] / counts[b,i] + vq_bias[hh,:])
// with the first maximum on ties (as torch.argmax and jnp.argmax).
//
// What bounds it on an H100: the patch is ~512 FP32 flops per live (row,
// column, head) against ~42 MB of compulsory traffic at the main path's
// shapes (B=4, n=1024, H=12, dh=Q=64: q, T_base, T and the mask), ~13 us at
// 3.35 TB/s. With 38% of the mask live, C=72 is ~0.7 GFLOP, ~10 us at the
// 67 TFLOP/s FP32 (non-tensor) peak, so bytes bound it there and at layer 0
// (C=8); operations bound it past ~100 columns (C=264: ~38 us), which the
// overflow fallback reaches as it doubles R (C = R + 8).
//
// What the design does about it (simple and correct first):
// * one block per (row tile of 32 rows, vq head, document); 4 threads per
//   row, each owning a strided quarter of dh and of Q, so the row's T slice,
//   its per-head patch sums and its score sum live in registers and q,
//   T_base and T cross device memory exactly once;
// * the k_new/k_old/vc_new/vc_old tiles of one head (4 x 32 columns x 64
//   floats) and the mask tile are staged once per block in shared memory and
//   reused by all 32 rows; the strided ownership keeps the shared-memory
//   reads free of bank conflicts;
// * a masked (row, column) pair skips its gelu and its two axpys, and a row
//   whose mask is all zero returns T_base bitwise (the patch sums start at
//   -0.0 - 0.0 = -0.0, and x + -0.0 == x for every x);
// * the products run on the FP32 CUDA cores in full precision. TF32 tensor
//   cores would flip VQ codes; a split-precision wgmma version is later work.
//
// delta_gate: one warp per row, a strided max of |x_new - x_old| and a warp
// shuffle reduce, then the strict compare. Bytes-bound (2 x r x d floats);
// max, abs and > are exact, so keep bits equal the plain version bitwise.
//
// Plain C interface, loaded with ctypes; each launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace {

using repro_torch::gelu_tanh;
using repro_torch::takes_first_max;

constexpr int DH = 64;                   // head dim (every served config)
constexpr int QC = 64;                   // codebook size
constexpr int ROWS = 32;                 // rows per block
constexpr int LANES = 4;                 // threads per row
constexpr int SLICE = DH / LANES;        // dims (and codes) per thread
constexpr int CT = 32;                   // columns per shared-memory tile
constexpr int THREADS = ROWS * LANES;    // 128
constexpr int GATE_WARPS = 8;            // rows per delta_gate block

static_assert(DH == QC, "one ownership pattern serves dh and Q");
static_assert(LANES == 4, "the row reduction below shuffles over 4 lanes");

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ q,       // [B, n, H, DH]
                  const float* __restrict__ k_new,   // [B, H, C, DH]
                  const float* __restrict__ k_old,    // [B, H, C, DH]
                  const float* __restrict__ vc_new,  // [B, H, C, QC]
                  const float* __restrict__ vc_old,  // [B, H, C, QC]
                  const float* __restrict__ mask,    // [B, n, C]
                  const float* __restrict__ t_base,  // [B, n, H, QC]
                  const float* __restrict__ counts,  // [B, n]
                  const float* __restrict__ vq_bias, // [hq, QC]
                  float* __restrict__ t_out,         // [B, n, H, QC]
                  int* __restrict__ codes,           // [B, n, hq]
                  int n, int H, int C, int g, float scale) {
  __shared__ float s_kn[CT][DH];
  __shared__ float s_ko[CT][DH];
  __shared__ float s_vn[CT][QC];
  __shared__ float s_vo[CT][QC];
  __shared__ float s_mask[ROWS][CT + 1];

  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int hq = gridDim.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int r = tid / LANES;     // row within the tile
  const int lane = tid % LANES;  // owns dims / codes lane, lane+4, lane+8, ...
  const int row = row0 + r;
  const bool live = row < n;     // rows past n compute garbage, write nothing

  float acc[SLICE];  // sum over the g heads of T[b, row, h, owned codes]
#pragma unroll
  for (int i = 0; i < SLICE; ++i) acc[i] = 0.0f;

  for (int j = 0; j < g; ++j) {
    const int h = hh * g + j;
    float qs[SLICE];
    const size_t q_off = (((size_t)b * n + (live ? row : 0)) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < SLICE; ++i) qs[i] = q[q_off + i * LANES + lane];
    float d_new[SLICE], d_old[SLICE];
#pragma unroll
    for (int i = 0; i < SLICE; ++i) {
      d_new[i] = -0.0f;
      d_old[i] = 0.0f;
    }
    const size_t col0 = ((size_t)b * H + h) * C;  // first column of (b, h)
    for (int c0 = 0; c0 < C; c0 += CT) {
      const int ct = min(CT, C - c0);
      __syncthreads();  // every thread is done with the previous tile
      for (int e = tid; e < ct * DH; e += THREADS) {
        const int c = e / DH, d = e % DH;
        const size_t src = (col0 + c0 + c) * DH + d;
        s_kn[c][d] = k_new[src];
        s_ko[c][d] = k_old[src];
      }
      for (int e = tid; e < ct * QC; e += THREADS) {
        const int c = e / QC, d = e % QC;
        const size_t src = (col0 + c0 + c) * QC + d;
        s_vn[c][d] = vc_new[src];
        s_vo[c][d] = vc_old[src];
      }
      for (int e = tid; e < ROWS * ct; e += THREADS) {
        const int rr = e / ct, c = e % ct;
        const int grow = row0 + rr;
        s_mask[rr][c] = grow < n ? mask[((size_t)b * n + grow) * C + c0 + c] : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < ct; ++c) {
        float pn = 0.0f, po = 0.0f;
#pragma unroll
        for (int i = 0; i < SLICE; ++i) {
          pn = fmaf(qs[i], s_kn[c][i * LANES + lane], pn);
          po = fmaf(qs[i], s_ko[c][i * LANES + lane], po);
        }
        // the 4 threads of a row are adjacent lanes: butterfly over them
        pn += __shfl_xor_sync(0xffffffffu, pn, 1);
        po += __shfl_xor_sync(0xffffffffu, po, 1);
        pn += __shfl_xor_sync(0xffffffffu, pn, 2);
        po += __shfl_xor_sync(0xffffffffu, po, 2);
        const float m = s_mask[r][c];
        if (m != 0.0f) {
          const float wn = gelu_tanh(pn * scale) * m;
          const float wo = gelu_tanh(po * scale) * m;
#pragma unroll
          for (int i = 0; i < SLICE; ++i) {
            d_new[i] = fmaf(wn, s_vn[c][i * LANES + lane], d_new[i]);
            d_old[i] = fmaf(wo, s_vo[c][i * LANES + lane], d_old[i]);
          }
        }
      }
    }
    const size_t t_off = (((size_t)b * n + (live ? row : 0)) * H + h) * QC;
#pragma unroll
    for (int i = 0; i < SLICE; ++i) {
      const int e = i * LANES + lane;
      const float t = t_base[t_off + e] + (d_new[i] - d_old[i]);
      if (live) t_out[t_off + e] = t;
      acc[i] = (j == 0) ? t : acc[i] + t;
    }
  }

  // requantize: scores = acc / counts + vq_bias, first maximum over Q
  const float cnt = counts[(size_t)b * n + (live ? row : 0)];
  float best = 0.0f;
  int best_idx = -1;
#pragma unroll
  for (int i = 0; i < SLICE; ++i) {
    const int code = i * LANES + lane;  // increasing in i: strict > keeps the first
    const float s = acc[i] / cnt + vq_bias[hh * QC + code];
    if (best_idx < 0 || s > best) {
      best = s;
      best_idx = code;
    }
  }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (takes_first_max(ob, oi, best, best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }
  if (live && lane == 0) codes[((size_t)b * n + row) * hq + hh] = best_idx;
}

__global__ void delta_gate_kernel(const float* __restrict__ x_new,  // [r, d]
                                  const float* __restrict__ x_old,  // [r, d]
                                  unsigned char* __restrict__ keep, // [r] bool
                                  int r, int d, float threshold) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * GATE_WARPS + warp;
  if (row >= r) return;  // warp-uniform: the shuffles below see a full warp
  const float* a = x_new + (size_t)row * d;
  const float* o = x_old + (size_t)row * d;
  float m = 0.0f;  // |diff| >= 0, and a NaN diff propagates like torch.amax
  for (int i = lane; i < d; i += 32) {
    const float v = fabsf(a[i] - o[i]);
    m = (v > m || v != v) ? v : m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, m, off);
    m = (other > m || other != other) ? other : m;
  }
  if (lane == 0) keep[row] = (m > threshold) ? 1 : 0;
}

}  // namespace

extern "C" int fused_step_launch(const float* q, const float* k_new,
                                 const float* k_old, const float* vc_new,
                                 const float* vc_old, const float* mask,
                                 const float* t_base, const float* counts,
                                 const float* vq_bias, float* t_out, int* codes,
                                 int B, int n, int H, int C, int g, float scale,
                                 cudaStream_t stream) {
  const dim3 grid((n + ROWS - 1) / ROWS, H / g, B);
  fused_step_kernel<<<grid, THREADS, 0, stream>>>(
      q, k_new, k_old, vc_new, vc_old, mask, t_base, counts, vq_bias, t_out,
      codes, n, H, C, g, scale);
  return (int)cudaGetLastError();
}

extern "C" int delta_gate_launch(const float* x_new, const float* x_old,
                                 unsigned char* keep, int r, int d,
                                 float threshold, cudaStream_t stream) {
  const dim3 grid((r + GATE_WARPS - 1) / GATE_WARPS);
  delta_gate_kernel<<<grid, GATE_WARPS * 32, 0, stream>>>(x_new, x_old, keep,
                                                          r, d, threshold);
  return (int)cudaGetLastError();
}
