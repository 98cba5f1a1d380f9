// Hand-written Hopper (sm_90a) kernel of causal sigma (GELU-gated) attention.
//
// Replaces the TPU Pallas kernel of
// src/repro/kernels/gated_attention/gated_attention.py: gated_attention_kernel
// (pallas_call at :90). For every (batch*head) bh and query row i < nq:
//   O[bh,i,:] = sum_{j <= i, j < nk} gelu(q[bh,i] . k[bh,j] * scale) v[bh,j,:]
//               / min(i + 1, nk)
// (paper eq. 1 with the count normalisation of repro/models/attention.py).
//
// What bounds it on an H100: operations. At the forward's shapes (BH = 48,
// n = 1024, dh = dv = 64) the causal half needs ~6.4 GFLOP of dot products
// and GELUs, ~0.1 ms at the 67 TFLOP/s FP32 peak, against ~38 MB of q, k, v
// and O, ~11 us at 3.35 TB/s.
//
// What the design does about it (simple and correct first):
// * the grid is (q tile of 64 rows, bh); the TPU's sequential kv grid axis
//   becomes a loop inside the block over 32-key tiles, which stops at the
//   tile holding the block's last row (tiles above the diagonal are never
//   loaded);
// * because sigma attention has no softmax, each key tile's contribution is
//   an independent partial sum: no running max, no rescale. The 64 x 64
//   output tile lives in registers (2 rows x 8 columns a thread) and is
//   normalised once at the end;
// * per key tile the block computes the 64 x 32 scores (2 x 4 a thread, q
//   and k staged in shared memory), applies the causal / ragged mask and the
//   GELU once per score into shared memory, then accumulates W V;
// * products run on the FP32 CUDA cores in full precision (no TF32). A
//   tensor-core (split-precision wgmma) version is later work.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

using repro_torch::gelu_tanh;

constexpr int DH = 64;              // head dim of q, k and v (dh == dv)
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile
constexpr int TX = 8;               // threads across the key / output columns
constexpr int THREADS = 256;        // 32 row pairs x 8 column lanes
constexpr int SC = BK / TX;         // score columns a thread owns (4)
constexpr int OC = DH / TX;         // output columns a thread owns (8)

static_assert(THREADS == (BQ / 2) * TX, "two query rows per thread row");

__global__ void __launch_bounds__(THREADS)
gated_attention_kernel(const float* __restrict__ q,  // [BH, nq, DH]
                       const float* __restrict__ k,  // [BH, nk, DH]
                       const float* __restrict__ v,  // [BH, nk, DH]
                       float* __restrict__ o,        // [BH, nq, DH]
                       int nq, int nk, float scale) {
  __shared__ float s_q[BQ][DH + 1];
  __shared__ float s_k[BK][DH + 1];
  __shared__ float s_v[BK][DH];
  __shared__ float s_w[BQ][BK + 1];

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / TX;   // owns query rows 2ty, 2ty + 1 of the tile
  const int tx = tid % TX;   // owns columns tx, tx + 8, ...
  const float* qb = q + bh * nq * DH;
  const float* kb = k + bh * nk * DH;
  const float* vb = v + bh * nk * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    s_q[r][d] = q0 + r < nq ? qb[(size_t)(q0 + r) * DH + d] : 0.0f;
  }

  float acc[2][OC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.0f;

  // causal: no key after the tile's last row (nor past nk) is ever attended
  const int last_key = min(q0 + BQ - 1, nk - 1);
  for (int k0 = 0; k0 <= last_key; k0 += BK) {
    __syncthreads();  // the previous tile's W V is done (and s_q is loaded)
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int c = e / DH, d = e % DH;
      const bool in = k0 + c < nk;
      s_k[c][d] = in ? kb[(size_t)(k0 + c) * DH + d] : 0.0f;
      s_v[c][d] = in ? vb[(size_t)(k0 + c) * DH + d] : 0.0f;
    }
    __syncthreads();

    float s[2][SC];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qa = s_q[2 * ty][d];
      const float qb2 = s_q[2 * ty + 1][d];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float kv = s_k[tx + TX * j][d];
        s[0][j] = fmaf(qa, kv, s[0][j]);
        s[1][j] = fmaf(qb2, kv, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + 2 * ty + i;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kj = k0 + tx + TX * j;
        s_w[2 * ty + i][tx + TX * j] =
            (kj <= qi && kj < nk) ? gelu_tanh(s[i][j] * scale) : 0.0f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float wa = s_w[2 * ty][c];
      const float wb = s_w[2 * ty + 1][c];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float vv = s_v[c][tx + TX * j];
        acc[0][j] = fmaf(wa, vv, acc[0][j]);
        acc[1][j] = fmaf(wb, vv, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * ty + i;
    if (qi >= nq) continue;
    const float cnt = (float)min(qi + 1, nk);
    float* orow = o + (bh * nq + qi) * DH;
#pragma unroll
    for (int j = 0; j < OC; ++j) orow[tx + TX * j] = acc[i][j] / cnt;
  }
}

}  // namespace

extern "C" int gated_attention_launch(const float* q, const float* k,
                                      const float* v, float* o, int BH, int nq,
                                      int nk, float scale,
                                      cudaStream_t stream) {
  const dim3 grid((nq + BQ - 1) / BQ, BH);
  gated_attention_kernel<<<grid, THREADS, 0, stream>>>(q, k, v, o, nq, nk,
                                                        scale);
  return (int)cudaGetLastError();
}
