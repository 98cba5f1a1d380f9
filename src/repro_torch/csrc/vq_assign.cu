// Hand-written Hopper (sm_90a) kernel of multi-head VQ assignment.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/vq_assign/vq_assign.py:
// vq_assign_kernel (pallas_call at :61) and vq_assign_kernel_batched (:103).
// For every document b, token t and vq head h:
//   scores[c] = x[b,t,h,:] . C[h,c,:] + bias[h,c]      bias = -||C[h,c]||^2 / 2
//   idx[b,t,h] = argmax_c scores[c]                     (first maximum on ties)
//   xq[b,t,h,:] = C[h, idx[b,t,h], :]
// (paper App. A.2: the argmax of the inner-product form is the nearest code).
// One kernel with a leading B: the unbatched wrapper is the case B = 1.
//
// What bounds it on an H100: bytes. At the main path's shapes (B*N = 4096
// tokens, hq = 2, Q = 64, dv = 384) it reads x and writes xq, 12.6 MB each,
// ~7.5 us at 3.35 TB/s, against 0.4 GFLOP of dot products, ~6 us at the
// 67 TFLOP/s FP32 peak. A decode call (N = 1) is pure launch latency.
//
// What the design does about it (simple and correct first):
// * one block per (tile of 32 tokens, vq head, document), 8 threads a token;
//   each thread owns the codes lane, lane+8, ... and keeps their dot
//   products in registers, so x is read from device memory once;
// * the head's codebook and the token tile are staged through shared memory
//   in 32-wide chunks of dv (dv and Q are runtime values, Q <= 256); the
//   codebook (96 KB a head at full width) is re-read by every block from L2;
// * the argmax is lane-local over increasing codes (strict >), then a
//   butterfly over the 8 lanes that keeps the lower index on ties;
// * xq is a direct indexed copy of the winning codebook row, not the TPU's
//   one-hot matmul, so it is bitwise C[idx];
// * the dot products run on the FP32 CUDA cores in full precision: TF32
//   tensor cores would flip codes.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

using repro_torch::takes_first_max;

constexpr int TOK = 32;                 // tokens per block
constexpr int LANES = 8;                // threads per token
constexpr int THREADS = TOK * LANES;    // 256
constexpr int QMAX = 256;               // largest codebook the kernel takes
constexpr int CODES = QMAX / LANES;     // codes per thread at most
constexpr int DC = 32;                  // dv chunk staged in shared memory

__global__ void __launch_bounds__(THREADS)
vq_assign_kernel(const float* __restrict__ x,     // [B, N, hq, dv]
                 const float* __restrict__ cb,    // [hq, Q, dv]
                 const float* __restrict__ bias,  // [hq, Q]
                 int* __restrict__ idx,           // [B, N, hq]
                 float* __restrict__ xq,          // [B, N, hq, dv]
                 int N, int Q, int dv) {
  __shared__ float s_x[TOK][DC + 1];
  __shared__ float s_cb[QMAX][DC + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hq = gridDim.y;
  const int tok0 = blockIdx.x * TOK;
  const int tid = threadIdx.x;
  const int r = tid / LANES;     // token within the tile
  const int lane = tid % LANES;  // owns codes lane, lane + 8, ...
  const int tok = tok0 + r;
  const bool live = tok < N;     // tokens past N compute garbage, write nothing
  const float* cbh = cb + (size_t)h * Q * dv;

  float acc[CODES];
#pragma unroll
  for (int j = 0; j < CODES; ++j) acc[j] = 0.0f;

  for (int d0 = 0; d0 < dv; d0 += DC) {
    const int dc = min(DC, dv - d0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = tid; e < TOK * dc; e += THREADS) {
      const int rr = e / dc, d = e % dc;
      const int t = tok0 + rr;
      s_x[rr][d] = t < N ? x[(((size_t)b * N + t) * hq + h) * dv + d0 + d] : 0.0f;
    }
    for (int e = tid; e < Q * dc; e += THREADS) {
      const int c = e / dc, d = e % dc;
      s_cb[c][d] = cbh[(size_t)c * dv + d0 + d];
    }
    __syncthreads();
    for (int d = 0; d < dc; ++d) {
      const float xv = s_x[r][d];
#pragma unroll
      for (int j = 0; j < CODES; ++j) {
        const int c = j * LANES + lane;
        if (c < Q) acc[j] = fmaf(xv, s_cb[c][d], acc[j]);
      }
    }
  }

  float best = 0.0f;
  int best_idx = -1;
#pragma unroll
  for (int j = 0; j < CODES; ++j) {
    const int c = j * LANES + lane;  // increasing in j: strict > keeps the first
    if (c < Q) {
      const float s = acc[j] + bias[h * Q + c];
      if (best_idx < 0 || s > best) {
        best = s;
        best_idx = c;
      }
    }
  }
  // the 8 threads of a token are adjacent lanes: butterfly over them
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (takes_first_max(ob, oi, best, best_idx)) {
      best = ob;
      best_idx = oi;
    }
  }
  if (!live) return;
  const size_t row = ((size_t)b * N + tok) * hq + h;
  if (lane == 0) idx[row] = best_idx;
  const float* src = cbh + (size_t)best_idx * dv;
  for (int d = lane; d < dv; d += LANES) xq[row * dv + d] = src[d];
}

}  // namespace

extern "C" int vq_assign_launch(const float* x, const float* cb,
                                const float* bias, int* idx, float* xq, int B,
                                int N, int hq, int Q, int dv,
                                cudaStream_t stream) {
  const dim3 grid((N + TOK - 1) / TOK, hq, B);
  vq_assign_kernel<<<grid, THREADS, 0, stream>>>(x, cb, bias, idx, xq, N, Q, dv);
  return (int)cudaGetLastError();
}
