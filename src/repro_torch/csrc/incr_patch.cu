// Hand-written Hopper (sm_90a) kernel of the incremental attention column
// patch (paper App. A.1).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/incr_patch/incr_patch.py:
// incr_patch_kernel (pallas_call at :75) and incr_patch_kernel_batched (:119).
// For every document b, row i and attention head h:
//   dT[b,i,h,:] = sum_c m[b,i,c] gelu(s q[b,i,h] . k_new[b,h,c]) vc_new[b,h,c,:]
//               - sum_c m[b,i,c] gelu(s q[b,i,h] . k_old[b,h,c]) vc_old[b,h,c,:]
// It is fused_step's patch loop (csrc/fused_step.cu) without the T
// accumulate and the requantize: the unfused edit step
// (use_patch_kernel=True) adds dT to T and requantizes in PyTorch. One kernel
// with a leading B: the unbatched wrapper is the case B = 1.
//
// What bounds it on an H100: at the edit path's shapes (B = 4, n = 1024,
// H = 12, dh = Q = 64) q and dT are ~25 MB each way, ~15 us at 3.35 TB/s;
// the patch is ~512 FP32 flops per live (row, column, head), so with ~40%
// of the mask live operations pass bytes from about C = 100 (C = 264:
// ~0.65 GFLOP live, ~10 us at 67 TFLOP/s).
//
// What the design does about it (simple and correct first, as fused_step):
// * one block per (tile of 32 rows, head, document); 4 threads a row, each
//   owning a strided quarter of dh and of Q, so q and dT cross device
//   memory once and the row's patch sums stay in registers;
// * the k_new / k_old / vc_new / vc_old tiles of the head (32 columns) and
//   the mask tile are staged once per block in shared memory and reused by
//   all 32 rows;
// * a masked (row, column) pair skips its GELU and its axpys, so a fully
//   masked row (a free slot, a filler document) writes exact zeros;
// * the products run on the FP32 CUDA cores in full precision (no TF32).
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"

namespace {

using repro_torch::gelu_tanh;

constexpr int DH = 64;                   // head dim (every served config)
constexpr int QC = 64;                   // codebook size
constexpr int ROWS = 32;                 // rows per block
constexpr int LANES = 4;                 // threads per row
constexpr int SLICE = DH / LANES;        // dims (and codes) per thread
constexpr int CT = 32;                   // columns per shared-memory tile
constexpr int THREADS = ROWS * LANES;    // 128

static_assert(DH == QC, "one ownership pattern serves dh and Q");
static_assert(LANES == 4, "the row reduction below shuffles over 4 lanes");

__global__ void __launch_bounds__(THREADS)
incr_patch_kernel(const float* __restrict__ q,       // [B, R, H, DH]
                  const float* __restrict__ k_new,   // [B, H, C, DH]
                  const float* __restrict__ k_old,   // [B, H, C, DH]
                  const float* __restrict__ vc_new,  // [B, H, C, QC]
                  const float* __restrict__ vc_old,  // [B, H, C, QC]
                  const float* __restrict__ mask,    // [B, R, C]
                  float* __restrict__ out,           // [B, R, H, QC]
                  int R, int H, int C, float scale) {
  __shared__ float s_kn[CT][DH];
  __shared__ float s_ko[CT][DH];
  __shared__ float s_vn[CT][QC];
  __shared__ float s_vo[CT][QC];
  __shared__ float s_mask[ROWS][CT + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int r = tid / LANES;     // row within the tile
  const int lane = tid % LANES;  // owns dims / codes lane, lane+4, lane+8, ...
  const int row = row0 + r;
  const bool live = row < R;     // rows past R compute garbage, write nothing

  float qs[SLICE];
  const size_t q_off = (((size_t)b * R + (live ? row : 0)) * H + h) * DH;
#pragma unroll
  for (int i = 0; i < SLICE; ++i) qs[i] = q[q_off + i * LANES + lane];
  float d_new[SLICE], d_old[SLICE];
#pragma unroll
  for (int i = 0; i < SLICE; ++i) {
    d_new[i] = 0.0f;
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
      s_mask[rr][c] = grow < R ? mask[((size_t)b * R + grow) * C + c0 + c] : 0.0f;
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
  if (!live) return;
  const size_t o_off = (((size_t)b * R + row) * H + h) * QC;
#pragma unroll
  for (int i = 0; i < SLICE; ++i) out[o_off + i * LANES + lane] = d_new[i] - d_old[i];
}

}  // namespace

extern "C" int incr_patch_launch(const float* q, const float* k_new,
                                 const float* k_old, const float* vc_new,
                                 const float* vc_old, const float* mask,
                                 float* out, int B, int R, int H, int C,
                                 float scale, cudaStream_t stream) {
  const dim3 grid((R + ROWS - 1) / ROWS, H, B);
  incr_patch_kernel<<<grid, THREADS, 0, stream>>>(q, k_new, k_old, vc_new,
                                                   vc_old, mask, out, R, H, C,
                                                   scale);
  return (int)cudaGetLastError();
}
