// Hand-written Hopper (sm_90a) kernels of the gradient of causal sigma
// (GELU-gated) attention, on the FP32 cores.
//
// The forward is csrc/gated_attention.cu (the port of the TPU Pallas kernel
// src/repro/kernels/gated_attention/gated_attention.py, pallas_call at :90).
// No TPU kernel has a backward: the reference trains by differentiating its
// plain-JAX sigma attention (src/repro/models/attention.py: attention_core).
// These kernels compute that gradient, for training's nq = nk = n and
// dh = dv = 64. With c_i = i + 1, S = q k^T * scale, W = gelu_tanh(S) * mask
// (key j <= query i) and dO' = dO / c:
//   dV = W^T dO'       dW = dO' V^T       dS = dW * gelu_tanh'(S) * mask
//   dQ = dS K * scale  dK = dS^T Q * scale
// S and W are recomputed here from q and k; the forward saves nothing else.
//
// Two kernels, no atomics, so every sum runs in a fixed order and two calls
// give the same bits:
// * dkv: one CTA per (64-key tile, bh). k and v stay in shared memory; the
//   CTA walks the query tiles at or after its key tile, recomputes S and dW
//   for the (64 query x 64 key) block, forms W and dS, and accumulates
//   dK += dS^T Q and dV += W^T dO' in registers.
// * dq: one CTA per (64-query tile, bh). q and dO' stay in shared memory; the
//   CTA walks the key tiles at or before its query tile, recomputes S and dW,
//   forms dS and accumulates dQ += dS K in registers.
// 256 threads a CTA (16 x 16), each holding a 4 x 4 register tile of every
// 64 x 64 product. Every product reads float4 rows of shared memory whose
// fast index is the tile's 4-wide register axis, so a tile is staged in the
// layout its product reads: [d][row] (transposed) for S = Q K^T and
// dW = dO' V^T (reduced over the head dim), [row][d] for the products
// reduced over queries or keys; the staging copy writes whichever layouts a
// kernel needs. Rows are padded to 68 floats: the staging stores and the
// float4 reads hit no bank twice. The CTAs of the heaviest tiles come first
// in the grid. Rows at or past n stage as zeros: a zero query row has zero
// dO', a zero key row is never attended, and neither is written back.
//
// What bounds it on an H100: operations. At the VQ-OPT-125M train step's
// shape (BH = 96, n = 1024, dh = 64) the gradient needs 5 products (S, dW,
// dV, dK, dQ) over 524,800 causal (query, key) pairs a bh, 32.2 GFLOP:
// 0.195 ms as 3xTF32 on the tensor cores (495 TFLOP/s, the forward's
// route), 0.481 ms at the 67 TFLOP/s of the FP32 cores. These kernels do 7
// (S and dW in both), 45.1 GFLOP. q, k, v, dO and the three gradients are
// 176 MB, 0.053 ms at 3.35 TB/s.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; device ms):
// BH = 96, n = 1024: 2.071 (dK/dV 1.31, dQ 0.77), 10.6x the 3xTF32 bound
// and 4.3x the FP32 one, against the plain version's 8.50; BH = 48 at
// n = 1024 / 1000 / 37 / 1: 1.010 / 1.006 / 0.028 / 0.026. dK/dV runs one CTA an SM (139 KB of shared memory,
// 111 registers), dQ two (104 KB, 80 registers); no spills. The FP32 FMAs
// reach ~32% (dK/dV) and ~40% (dQ) of the FP32 peak.
//
// Plain C interface, loaded with ctypes; each launcher returns the CUDA error
// code so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::gelu_tanh;

constexpr int DH = 64;            // head dim of q, k and v
constexpr int BT = 64;            // rows (queries or keys) of a tile
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int LD = BT + 4;        // padded stride (floats) of a staged row
constexpr int TILE = DH * LD;     // floats of one staged 64 x 64 tile

// d/dx of the tanh GELU of common.cuh
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float t = tanhf(kBeta * (x + kKappa * (x * x * x)));
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * kBeta * (1.0f + 3.0f * kKappa * x * x);
}

// Stage rows [row0, row0 + 64) of a [n, 64] matrix (rows >= n as zeros; with
// by_count each row i divided by i + 1, as dO' = dO / c) into shared memory:
// row-major rm[r * LD + d] and / or transposed tr[d * LD + r] (null: skip).
// Consecutive threads take consecutive rows of one 4-column chunk.
__device__ __forceinline__ void stage(const float* __restrict__ src, int row0, int n,
                                      bool by_count, float* rm, float* tr) {
  for (int idx = threadIdx.x; idx < BT * DH / 4; idx += THREADS) {
    const int r = idx % BT, c = idx / BT;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      x = *reinterpret_cast<const float4*>(src + (size_t)row * DH + 4 * c);
      if (by_count) {
        const float cnt = (float)(row + 1);
        x.x /= cnt;
        x.y /= cnt;
        x.z /= cnt;
        x.w /= cnt;
      }
    }
    if (rm) *reinterpret_cast<float4*>(rm + r * LD + 4 * c) = x;
    if (tr) {
      tr[(4 * c + 0) * LD + r] = x.x;
      tr[(4 * c + 1) * LD + r] = x.y;
      tr[(4 * c + 2) * LD + r] = x.z;
      tr[(4 * c + 3) * LD + r] = x.w;
    }
  }
}

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// acc[i][j] += sum_t A[t][a0 + i] * B[t][b0 + j] over t < 64, A and B
// staged with t as the slow index (float4 reads at a0 and b0).
__device__ __forceinline__ void product(const float* A, int a0, const float* B, int b0,
                                        float (&acc)[4][4]) {
#pragma unroll 8
  for (int t = 0; t < 64; ++t) {
    float a[4], b[4];
    unpack(*reinterpret_cast<const float4*>(A + t * LD + a0), a);
    unpack(*reinterpret_cast<const float4*>(B + t * LD + b0), b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// S = Q K^T and dW = dO' V^T of one (query tile, key tile) block, from the
// transposed tiles, then in place: s <- W = gelu(S * scale) * mask and
// dw <- dS = dW * gelu'(S * scale) * mask. The thread's queries are
// qrow0 + i, its keys krow0 + j (absolute rows, for the causal mask).
__device__ __forceinline__ void scores(const float* Qt, const float* Kt, const float* dOt,
                                       const float* Vt, int ty, int tx, int qrow0, int krow0,
                                       bool diagonal, float scale, float (&s)[4][4],
                                       float (&dw)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dw[i][j] = 0.f;
  product(Qt, 4 * ty, Kt, 4 * tx, s);
  product(dOt, 4 * ty, Vt, 4 * tx, dw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = s[i][j] * scale;
      const bool live = !diagonal || krow0 + j <= qrow0 + i;
      s[i][j] = live ? gelu_tanh(x) : 0.f;
      dw[i][j] = live ? dw[i][j] * gelu_tanh_grad(x) : 0.f;
    }
}

__global__ void __launch_bounds__(THREADS)
gated_attention_bwd_dkv_kernel(const float* __restrict__ q,   // [BH, n, 64]
                               const float* __restrict__ k,   // [BH, n, 64]
                               const float* __restrict__ v,   // [BH, n, 64]
                               const float* __restrict__ dO,  // [BH, n, 64]
                               float* __restrict__ dk,        // [BH, n, 64]
                               float* __restrict__ dv,        // [BH, n, 64]
                               int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [d][key]
  float* Vt = Kt + TILE;       // [d][key]
  float* Qr = Vt + TILE;       // [query][d]
  float* Qt = Qr + TILE;       // [d][query]
  float* Or = Qt + TILE;       // dO' [query][d]
  float* Ot = Or + TILE;       // dO' [d][query]
  float* W = Ot + TILE;        // [query][key]
  float* dS = W + TILE;        // [query][key]
  const size_t base = (size_t)blockIdx.x * n * DH;
  const int kt = blockIdx.y;   // key tile 0 (the most query tiles) first
  const int k0 = kt * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage(k + base, k0, n, false, nullptr, Kt);
  stage(v + base, k0, n, false, nullptr, Vt);
  float acc_k[4][4] = {}, acc_v[4][4] = {};
  const int tiles = (n + BT - 1) / BT;
  for (int qt = kt; qt < tiles; ++qt) {
    const int q0 = qt * BT;
    stage(q + base, q0, n, false, Qr, Qt);
    stage(dO + base, q0, n, true, Or, Ot);
    __syncthreads();
    float s[4][4], dw[4][4];
    scores(Qt, Kt, Ot, Vt, ty, tx, q0 + 4 * ty, k0 + 4 * tx, qt == kt, scale, s, dw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(W + (4 * ty + i) * LD + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dS + (4 * ty + i) * LD + 4 * tx) =
          make_float4(dw[i][0], dw[i][1], dw[i][2], dw[i][3]);
    }
    __syncthreads();
    // this thread's keys 4 ty + i, head dims 4 tx + j
    product(W, 4 * ty, Or, 4 * tx, acc_v);
    product(dS, 4 * ty, Qr, 4 * tx, acc_k);
    __syncthreads();  // the next tile's staging overwrites Q, dO', W, dS
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= n) continue;
    *reinterpret_cast<float4*>(dk + base + (size_t)key * DH + 4 * tx) = make_float4(
        acc_k[i][0] * scale, acc_k[i][1] * scale, acc_k[i][2] * scale, acc_k[i][3] * scale);
    *reinterpret_cast<float4*>(dv + base + (size_t)key * DH + 4 * tx) =
        make_float4(acc_v[i][0], acc_v[i][1], acc_v[i][2], acc_v[i][3]);
  }
}

__global__ void __launch_bounds__(THREADS)
gated_attention_bwd_dq_kernel(const float* __restrict__ q,   // [BH, n, 64]
                              const float* __restrict__ k,   // [BH, n, 64]
                              const float* __restrict__ v,   // [BH, n, 64]
                              const float* __restrict__ dO,  // [BH, n, 64]
                              float* __restrict__ dq,        // [BH, n, 64]
                              int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [d][query]
  float* Ot = Qt + TILE;       // dO' [d][query]
  float* Kr = Ot + TILE;       // [key][d]
  float* Kt = Kr + TILE;       // [d][key]
  float* Vt = Kt + TILE;       // [d][key]
  float* dSt = Vt + TILE;      // [key][query]
  const size_t base = (size_t)blockIdx.x * n * DH;
  const int tiles = (n + BT - 1) / BT;
  const int qt = tiles - 1 - blockIdx.y;  // the last query tile (the most key tiles) first
  const int q0 = qt * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  stage(q + base, q0, n, false, nullptr, Qt);
  stage(dO + base, q0, n, true, nullptr, Ot);
  float acc[4][4] = {};
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BT;
    stage(k + base, k0, n, false, Kr, Kt);
    stage(v + base, k0, n, false, nullptr, Vt);
    __syncthreads();
    float s[4][4], ds[4][4];
    scores(Qt, Kt, Ot, Vt, ty, tx, q0 + 4 * ty, k0 + 4 * tx, qt == kt, scale, s, ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dSt + (4 * tx + j) * LD + 4 * ty) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    // this thread's queries 4 ty + i, head dims 4 tx + j
    product(dSt, 4 * ty, Kr, 4 * tx, acc);
    __syncthreads();  // the next tile's staging overwrites K, V, dS
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= n) continue;
    *reinterpret_cast<float4*>(dq + base + (size_t)row * DH + 4 * tx) = make_float4(
        acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale, acc[i][3] * scale);
  }
}

constexpr int DKV_SMEM = 8 * TILE * (int)sizeof(float);  // 139,264 B
constexpr int DQ_SMEM = 6 * TILE * (int)sizeof(float);   // 104,448 B

}  // namespace

// dK and dV of the gradient (q, k, v, dO all [BH, n, 64]).
extern "C" int gated_attention_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                              const float* dO, float* dk, float* dv, int BH,
                                              int n, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT);
  gated_attention_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, stream>>>(q, k, v, dO, dk, dv, n,
                                                                      scale);
  return (int)cudaGetLastError();
}

// dQ of the gradient.
extern "C" int gated_attention_bwd_dq_launch(const float* q, const float* k, const float* v,
                                             const float* dO, float* dq, int BH, int n,
                                             float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gated_attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (n + BT - 1) / BT);
  gated_attention_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, stream>>>(q, k, v, dO, dq, n, scale);
  return (int)cudaGetLastError();
}
