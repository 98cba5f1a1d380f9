// Hand-written Hopper (sm_90a) kernel of the incremental attention column
// patch (paper App. A.1).
//
// Replaces the TPU Pallas kernels of src/repro/kernels/incr_patch/incr_patch.py:
// incr_patch_kernel (pallas_call at :75) and incr_patch_kernel_batched (:119).
// For every document b, row i and attention head h:
//   dT[b,i,h,:] = sum_c m[b,i,c] gelu(s q[b,i,h] . k_new[b,h,c]) vc_new[b,h,c,:]
//               - sum_c m[b,i,c] gelu(s q[b,i,h] . k_old[b,h,c]) vc_old[b,h,c,:]
// It is fused_step's patch (csrc/fused_step.cu) without the T accumulate and
// the requantize: the unfused edit step (use_patch_kernel=True) adds dT to T
// and requantizes in PyTorch. One launcher with a leading B: the unbatched
// wrapper is the case B = 1.
//
// What bounds it on an H100: the patch is ~512 FP32 flops per live (row,
// column, head). At the kernels check's B = 4, n = 1024, H = 12, dh = Q = 64
// with 38% of the mask live, q and dT are ~25 MB each way and C = 8 is
// bytes-bound (0.0077 ms at 3.35 TB/s); operations bind from about C = 72
// (0.0104 ms at 67 TFLOP/s) to C = 264 (0.0382 ms). The served steps are
// mostly single documents at C = 8 to 1032 (1x1024x1032, 51% live, is
// bound at 0.0498 ms).
//
// The design follows fused_step's (its helpers are in patch_tile.cuh):
// * A 64-row tile of one head and document at a time. S = q k^T over a
//   32-column tile, register-tiled 4 x 4 a thread (a 16-byte shared load
//   feeds 8 FMAs); W = gelu(scale S) m once per (row, column, head), stored
//   transposed; dT += W vc in 4 x 8 tiles a thread, dT_new and dT_old by
//   different threads, subtracted once in the epilogue and written as
//   float4.
// * Two layouts of the same threads (ops.split picks one by shape): one CTA
//   of 256 threads does both products (two CTAs an SM, ~104 KB of shared
//   memory, 128 registers with small spills), or two CTAs of 128 threads,
//   one a product (three an SM, ~61 KB, 168 registers, no spills), the
//   second to finish reading the other's dT from L2 (an arrival count a
//   (row tile, head, document), reset by that CTA) and writing dT_new -
//   dT_old. Every sum runs in the same order in both, so their results are
//   equal to the bit (and, as measured, to the plain version's). The split
//   doubles the CTAs where a single document leaves SMs idle (192 CTAs on
//   132 SMs at n = 1024) and stops the spills; it costs a second q and mask
//   read and the exchange, which lose at one or two column tiles.
// * q and the column tiles come through a double-buffered ring of 16-byte
//   cp.async copies: tile t + 1 is in flight while tile t is used.
// * Dead work is skipped: a row tile with no live column stages nothing and
//   writes zeros; a dead (row tile, column tile) pair skips both products.
//   A row with no live column sums only exact zeros, so it writes 0.
// * No T_base and no requantize: one count a pair is the only cross-CTA
//   state, and only the split layout uses it.
// * Full FP32 on the CUDA cores (no TF32, no library call).
//
// Measured (chip_smoke.py --sweep, NVIDIA H100 80GB HBM3, 700.00 W; device
// ms by kernel name, random mask): B=1 0.0078 / 0.0241 / 0.0376 / 0.0639 /
// 0.1149 / 0.2200 at C = 8 / 72 / 136 / 264 / 520 / 1032 (the previous
// kernel 0.0084 / 0.0450 / 0.0804 / 0.1527 / 0.2966 / 0.5991, slower than
// plain from C = 136); B=4 0.0186 / 0.0661 / 0.1043 / 0.1818 at C = 8 / 72
// / 136 / 264 (previous 0.0251 / 0.1448 / 0.2580 / 0.5012). Below plain
// and below fused_step at every shape measured; 4-6x the bound at C >= 72.
// What holds it: shared-memory operand traffic (2-2.7 FMAs a loaded
// float), the ring's copies, barriers, mask loads and GELUs of each tile,
// and at C = 8 the latency of one tile's chain.
//
// Plain C interface, loaded with ctypes; the launcher returns the CUDA error
// of its launch so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "common.cuh"
#include "patch_tile.cuh"

namespace {

using namespace repro_torch::patch_tile;
using repro_torch::gelu_tanh;

// Dynamic shared memory of a CTA that works on NPROD products, in bytes:
// the q tile, two ring stages of 2 NPROD column tiles, NPROD W^T tiles and
// the last-arrival flag.
constexpr int smem_bytes(int nprod) {
  return 4 * (Q_FLOATS + 2 * 2 * nprod * CT * PAD + nprod * CT * WS) + 16;
}

// NPROD = 2: one CTA of 256 threads computes both products of a (row tile,
// head, document); NPROD = 1: two CTAs of 128 threads, one a product, and
// the second to finish writes dT_new - dT_old (three an SM).
template <int NPROD>
__global__ void __launch_bounds__(2 * RT * NPROD, NPROD == 2 ? 2 : 3)
incr_patch_kernel(const float* __restrict__ q,       // [B, R, H, DH]
                  const float* __restrict__ k_new,   // [B, H, C, DH]
                  const float* __restrict__ k_old,   // [B, H, C, DH]
                  const float* __restrict__ vc_new,  // [B, H, C, QC]
                  const float* __restrict__ vc_old,  // [B, H, C, QC]
                  const float* __restrict__ mask,    // [B, R, C]
                  float* __restrict__ out,           // [B, R, H, QC]
                  float* __restrict__ part,          // [B, R, H, QC]: dT_old (NPROD = 1)
                  int* __restrict__ arrived,         // [B, ceil(R / RT), H], zero
                  int R, int H, int C, float scale) {
  constexpr int NT = 2 * RT * NPROD;  // threads
  constexpr int NA = 2 * NPROD;       // column tiles a ring stage holds
  constexpr int STAGE = NA * CT * PAD;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [RT][PAD]
  float* ring = q_s + Q_FLOATS;       // [2][NA][CT][PAD]: the products' k, then their vc
  float* w_s = ring + 2 * STAGE;      // [NPROD][CT][WS]
  int* is_last = reinterpret_cast<int*>(w_s + NPROD * CT * WS);

  const int tid = threadIdx.x;
  const int tile = NPROD == 2 ? blockIdx.x : blockIdx.x / 2;
  const int mat = NPROD == 2 ? tid / (2 * RT) : blockIdx.x % 2;  // 0 new, 1 old
  const int pm = NPROD == 2 ? mat : 0;  // the product's place in ring and W
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = tile * RT;
  const int nt = (C + CT - 1) / CT;
  const float* mask_b = mask + (size_t)b * R * C;
  const size_t col0 = ((size_t)b * H + h) * C;  // first column of (b, h)
  const size_t out_bh = ((size_t)b * R * H + h) * QC;  // row i at + i * H * QC

  // ---- does any row of the tile have a live column? (stops at the first
  // chunk of the mask that holds one: at once for a live tile)
  bool tile_live = false;
  {
    const size_t len = (size_t)min(RT, R - row0) * C;
    const float* mt = mask_b + (size_t)row0 * C;
    for (size_t base = 0; base < len && !tile_live; base += 8 * NT) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const size_t e = base + tid + k * NT;
        any |= e < len && __ldg(mt + e) != 0.0f;
      }
      tile_live = __syncthreads_or(any);
    }
  }
  if (!tile_live) {  // nothing to patch: zeros, written by the new product's CTA
    if (mat != 0 && NPROD == 1) return;
#pragma unroll
    for (int k = 0; k < RT * 16 / NT; ++k) {
      const int e = tid + k * NT;
      const int r = e / 16, d4 = e % 16;
      if (row0 + r < R)
        st4(out + out_bh + (size_t)(row0 + r) * H * QC + 4 * d4,
            make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }

  auto stage = [&](int c0, float* dst) {  // the column tile at c0, zero past C
#pragma unroll
    for (int a = 0; a < NA; ++a) {  // CT columns x 16 chunks of 16 bytes each
      const float* src =
          (NPROD == 2 ? (a == 0 ? k_new : a == 1 ? k_old : a == 2 ? vc_new : vc_old)
                      : (a == 0 ? (mat ? k_old : k_new) : (mat ? vc_old : vc_new)))
          + col0 * DH;
#pragma unroll
      for (int k = 0; k < CT * 16 / NT; ++k) {
        const int e = tid + k * NT;
        const int c = e / 16, d4 = e % 16;
        const bool ok = c0 + c < C;
        cp_async16(dst + (a * CT + c) * PAD + 4 * d4,
                   src + (size_t)(ok ? c0 + c : 0) * DH + 4 * d4, ok);
      }
    }
  };
#pragma unroll
  for (int k = 0; k < RT * 16 / NT; ++k) {  // the q tile, zero past R
    const int e = tid + k * NT;
    const int r = e / 16, d4 = e % 16;
    const int row = row0 + r;
    const bool ok = row < R;
    cp_async16(q_s + r * PAD + 4 * d4,
               q + (((size_t)b * R + (ok ? row : 0)) * H + h) * DH + 4 * d4, ok);
  }
  stage(0, ring);
  cp_async_commit();

  // The thread works on product mat at (sr, sc) of a 16 x 8 grid. S
  // (phases A, B): rows 4 sr + i, columns sc + 8 j; a quarter warp shares
  // sr (broadcast q loads) and reads 8 k columns a step. dT (phase C):
  // rows 4 sr + i, codes 4 sc + e and 32 + 4 sc + e (2.7 FMAs a loaded
  // float); a quarter warp shares sr (a broadcast W load) and reads 128
  // contiguous bytes of vc. Each sum runs in the plain version's order (d,
  // then c, ascending), whatever NPROD.
  const int sr = (tid % (2 * RT)) / 8, sc = tid % 8;
  float acc[4][8];  // dT of product mat
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const int s = t & 1;
    const int c0 = t * CT;
    const int ct = min(CT, C - c0);
    // the mask of the S micro-tile, loaded before the wait so its latency hides
    float m[4][4];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + 4 * sr + i, c = c0 + sc + 8 * j;
        m[i][j] = (row < R && c < C) ? __ldg(mask_b + (size_t)row * C + c) : 0.0f;
        any |= m[i][j] != 0.0f;
      }
    cp_async_wait<0>();  // tile t (and the q tile) have landed
    // every thread is done with tile t - 1 (ring slot s ^ 1 and W are free);
    // a dead (row tile, column tile) pair skips both products
    const bool live = __syncthreads_or(any);
    if (t + 1 < nt) {  // in flight while this tile is used
      stage(c0 + CT, ring + (s ^ 1) * STAGE);
      cp_async_commit();
    }
    if (!live) continue;
    // ---- phase A: S for rows 4 sr + i, columns sc + 8 j
    float acc_s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s[i][j] = 0.0f;
    const float* q_r = q_s + 4 * sr * PAD;
    const float* k_c = ring + s * STAGE + (pm * CT + sc) * PAD;
    switch ((ct + 7) / 8) {  // the column groups that hold a column
      case 4: s_product<4>(q_r, k_c, acc_s); break;
      case 3: s_product<3>(q_r, k_c, acc_s); break;
      case 2: s_product<2>(q_r, k_c, acc_s); break;
      default: s_product<1>(q_r, k_c, acc_s); break;
    }
    // ---- phase B: W = gelu(scale S) m, once per (row, column), to W^T as
    // float4 over the thread's 4 rows
    float* wt = w_s + pm * CT * WS + 4 * sr;
    float wv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j][i] = gelu_tanh(acc_s[i][j] * scale) * m[i][j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st4(wt + (sc + 8 * j) * WS, make_float4(wv[j][0], wv[j][1], wv[j][2], wv[j][3]));
    __syncthreads();  // W is whole
    // ---- phase C: dT += W vc
    const float* vt = ring + s * STAGE + (NPROD + pm) * CT * PAD + 4 * sc;
#pragma unroll 8
    for (int c = 0; c < ct; ++c) {
      const float4 w = ld4(wt + c * WS);
      const float4 v0 = ld4(vt + c * PAD), v1 = ld4(vt + c * PAD + 32);
      const float wr[4] = {w.x, w.y, w.z, w.w};
      const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(wr[i], vr[e], acc[i][e]);
    }
  }

  // ---- epilogue: dT_new - dT_old, taken once, written as float4. The old
  // product's sums reach the new product's threads through shared memory
  // (NPROD = 2, the free ring) or through part (NPROD = 1: the second CTA
  // of the pair to arrive reads the other's sums from L2).
  float* dst = NPROD == 1 && mat == 1 ? part : out;
  const float* other = out;  // unused when NPROD = 2
  if (NPROD == 2) {
    __syncthreads();  // every product is done with the ring
    float* dold_s = ring;  // [RT][PAD]
    if (mat == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* d = dold_s + (4 * sr + i) * PAD + 4 * sc;
        st4(d, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
        st4(d + 32, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
      }
    }
    __syncthreads();
    if (mat == 1) return;
    other = dold_s;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // this product's sums, for the other CTA
      const int r = 4 * sr + i;
      if (row0 + r >= R) break;
      float* o = dst + out_bh + (size_t)(row0 + r) * H * QC + 4 * sc;
      st4(o, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      st4(o + 32, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
    __threadfence();  // visible before this CTA's arrival counts
    __syncthreads();
    if (tid == 0) {
      int* cnt = arrived + ((size_t)b * (gridDim.x / 2) + tile) * H + h;
      *is_last = atomicAdd(cnt, 1) == 1;
      if (*is_last) *cnt = 0;  // zero again for the next launch
    }
    __syncthreads();
    if (!*is_last) return;
    __threadfence();  // the other CTA's sums, seen after its arrival
    other = mat == 0 ? part : out;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * sr + i;
    if (row0 + r >= R) break;
    const float* o = NPROD == 2 ? other + r * PAD + 4 * sc
                                : other + out_bh + (size_t)(row0 + r) * H * QC + 4 * sc;
    const float4 o0 = NPROD == 2 ? ld4(o) : __ldcg(reinterpret_cast<const float4*>(o));
    const float4 o1 = NPROD == 2 ? ld4(o + 32)
                                 : __ldcg(reinterpret_cast<const float4*>(o + 32));
    float d[8];
    const float ov[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = mat == 0 ? acc[i][e] - ov[e] : ov[e] - acc[i][e];
    float* w = out + out_bh + (size_t)(row0 + r) * H * QC + 4 * sc;
    st4(w, make_float4(d[0], d[1], d[2], d[3]));
    st4(w + 32, make_float4(d[4], d[5], d[6], d[7]));
  }
}

template <int NPROD>
int launch(const float* q, const float* k_new, const float* k_old, const float* vc_new,
           const float* vc_old, const float* mask, float* out, float* part,
           int* arrived, int B, int R, int H, int C, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(NPROD);
  cudaError_t err = cudaFuncSetAttribute(
      incr_patch_kernel<NPROD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + RT - 1) / RT * (3 - NPROD), H, B);
  incr_patch_kernel<NPROD><<<grid, 2 * RT * NPROD, bytes, stream>>>(
      q, k_new, k_old, vc_new, vc_old, mask, out, part, arrived, R, H, C, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// split = 0: one CTA a (row tile, head, document); 1: a CTA a product, two
// a (row tile, head, document), paired through part and arrived (the
// result is the same to the bit).
extern "C" int incr_patch_launch(const float* q, const float* k_new,
                                 const float* k_old, const float* vc_new,
                                 const float* vc_old, const float* mask,
                                 float* out, float* part, int* arrived, int B,
                                 int R, int H, int C, int split, float scale,
                                 cudaStream_t stream) {
  return split ? launch<1>(q, k_new, k_old, vc_new, vc_old, mask, out, part, arrived,
                           B, R, H, C, scale, stream)
               : launch<2>(q, k_new, k_old, vc_new, vc_old, mask, out, part, arrived,
                           B, R, H, C, scale, stream);
}
