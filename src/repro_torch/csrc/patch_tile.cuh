// Tile helpers of the attention column patch, shared by fused_step.cu and
// incr_patch.cu. Both compute, for a 64-row tile of one attention head,
//   dT = sum_c m[i,c] gelu(s q.k_new[c]) vc_new[c] - sum_c m[i,c] gelu(s q.k_old[c]) vc_old[c]
// over 32-column tiles staged in shared memory with a padded stride.
//
// Only the helpers are shared. The phases' bodies (the mask micro-tile, S,
// W, dT += W vc) stay written out in each kernel: moved here as shared
// functions they compiled fused_step to other spills and cost it 1.5-4%
// (chip_smoke.py's sweep, PERF.md), and incr_patch lays its threads out in
// two ways.
#pragma once

#include <stddef.h>

namespace repro_torch {
namespace patch_tile {

constexpr int DH = 64;                   // head dim (every served config)
constexpr int QC = 64;                   // codebook size
constexpr int RT = 64;                   // rows per CTA
constexpr int CT = 32;                   // columns per tile
constexpr int THREADS = 4 * RT;          // both products, 128 threads each
constexpr int PAD = DH + 4;              // padded stride of a staged q row, k / vc column
constexpr int WS = RT + 4;               // padded stride of W^T [column][row]

static_assert(DH == QC, "one staging pattern serves q, k, vc and T_base");

// dynamic shared memory of a CTA that works on both products, in floats
constexpr int Q_FLOATS = RT * PAD;                // q tile [RT][PAD]
constexpr int STAGE_FLOATS = 4 * CT * PAD;        // k_new, k_old, vc_new, vc_old
constexpr int RING_FLOATS = 2 * STAGE_FLOATS;     // two stages
constexpr int W_FLOATS = 2 * CT * WS;             // W^T new and old [CT][WS]

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// S[i][j] = q row i . k column (8 j) over DH for the first NJ column
// groups: q_r points at the thread's first q row, k_c at its first column.
template <int NJ>
__device__ __forceinline__ void s_product(const float* q_r, const float* k_c,
                                          float (&acc)[4][4]) {
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = ld4(q_r + i * PAD + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 kv = ld4(k_c + 8 * j * PAD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][j];
        a = fmaf(qv[i].x, kv.x, a);
        a = fmaf(qv[i].y, kv.y, a);
        a = fmaf(qv[i].z, kv.z, a);
        a = fmaf(qv[i].w, kv.w, a);
        acc[i][j] = a;
      }
    }
  }
}

}  // namespace patch_tile
}  // namespace repro_torch
