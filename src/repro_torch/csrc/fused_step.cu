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
// column, head) against ~42 MB of compulsory traffic at the kernels check's
// shapes (B=4, n=1024, H=12, dh=Q=64: q, T_base, T and the mask), ~13 us at
// 3.35 TB/s. With 38% of the mask live, C=72 is ~0.7 GFLOP, ~10 us at the
// 67 TFLOP/s FP32 (non-tensor) peak, so bytes bound it at C=72 (0.0127 ms)
// and at layer 0 (C=8, 0.0114 ms); operations bound it past ~100 columns
// (C=264: 0.0383 ms), which the overflow fallback reaches as it doubles R
// (C = R + 8). The served steps are single documents at C = 8 to 1032.
//
// The design, a flash-style two-stage product per (64-row tile, head):
// * One CTA per (64-row tile, attention head, document), 256 threads, two
//   an SM (~104 KB of dynamic shared memory, 128 registers): B=1, n=1024,
//   H=12 gives 192 CTAs. The old kernel's 32-row block walked its g heads
//   one after another over 128 threads (256 blocks at B=4, 64 at B=1).
// * S = q k^T over a 32-column tile, register-tiled: a thread owns 4 rows x 4
//   columns of S_new or S_old (a 16-byte shared load feeds 8 FMAs); W =
//   gelu(scale S) m is computed once per (row, column, head), as the plain
//   version does (a branch that skipped the tanhf where m = 0 was slower),
//   and goes to shared memory transposed. The old kernel read one shared
//   float per FMA and evaluated each GELU on 4 lanes.
// * dT += W vc, register-tiled: a thread owns 4 rows x 8 codes of dT_new or
//   of dT_old (kept apart, subtracted once in the epilogue, where the old
//   product's threads hand theirs over in shared memory). Each sum runs in
//   the plain version's order (d, then c, ascending): T matched the plain
//   version bitwise in every case measured.
// * The q tile and the k_new/k_old/vc_new/vc_old column tiles are copied
//   with 16-byte cp.async into a double-buffered ring: tile t + 1 is in
//   flight while tile t is used; T_base follows into the q tile's place
//   once the last tile's S is done, so its read overlaps the last product.
// * Dead work is skipped: a row tile whose mask is all zero (found by a scan
//   that stops at the first live entry) stages no q or k/vc and writes
//   T_base; a (row tile, column tile) pair whose mask is all zero
//   (__syncthreads_or) skips both products; a row with no live column
//   writes T_base itself, so -0.0 keeps its sign.
// * The requantize needs the g heads of a vq head: each CTA writes its T,
//   and the last of the g CTAs of a (row tile, vq head) to arrive (an
//   atomic count, reset by that CTA) sums their T rows from L2 in head
//   order j = 0..g-1 and takes the first maximum; the others leave at once.
//   (A thread-block cluster that summed over distributed shared memory
//   held every CTA until the slowest of its cluster; it was slower.)
// * Everything is full FP32 on the CUDA cores: TF32 tensor cores flip VQ
//   codes (a split-precision version is later work).
// * The tile helpers (cp.async, float4 loads and stores, the S product) are
//   in patch_tile.cuh, shared with incr_patch.cu.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; device ms by
// kernel name at B=4, n=1024, 38% live): 0.0331 / 0.0798 / 0.2117 at C = 8
// / 72 / 264 (old kernel 0.0409 / 0.2231 / 0.7662; plain 0.1185 / 0.2144 /
// 0.5605); B=1: 0.0164 / 0.0328 / 0.0890 / 0.3002 at C = 8 / 72 / 264 /
// 1032 (old 0.0301 / 0.1634 / 0.5604 at C <= 264). What holds it:
// shared-memory operand traffic (2-2.7 FMAs a loaded float where 4 would
// balance the FP32 pipes), 128 registers with small spills, and the
// grid's tail (576 busy CTAs at B=4 fill 2.2 waves of 264 slots; 192 at
// B=1 leave 72 SMs with one CTA).
//
// delta_gate: keep[i] = max_d |x_new[i,d] - x_old[i,d]| > threshold. Its
// bound is bytes (2 x r x d floats, 0.47 us at r=256, d=768), but at the
// served r (64 to 1024 rows of d=768) the inputs are L2-warm and a call is a
// launch (a one-element zero_() takes ~1 us on the card) plus memory round
// trips; from r ~ 1024 on, the L2's bandwidth. One warp a row, rows_per_cta
// rows a CTA, 16-byte loads where d % 4 == 0 and both bases are 16-byte
// aligned (else a scalar loop of the same bits); a lane takes its row in
// passes of GATE_CHUNKS chunks of each input (one pass at d=768), loaded in
// one of two ways, chosen with rows_per_cta by the wrapper from r
// (kernels/fused_step/ops.py gate_shape):
// * burst: every load of the pass before the first max, chunks past the
//   row's end skipped. One round trip a row; fastest while the rows leave
//   most of the card idle (r <= 512).
// * stream: chunks past the row's end load the last chunk again (the max
//   does not change), so the pass has no branch, and the compiler
//   interleaves its loads with the max, two chunks in flight (35 registers
//   against 78). Fewer requests queue at the L2 once the rows fill the card
//   (r > 512).
// A row over several warps with a shared-memory step, and an explicitly
// prefetched loop, were measured slower (PERF.md §6, delta_gate). The max
// is taken on the bits of |diff|, which order as unsigned integers as the
// floats do, with every NaN above +inf: the unsigned max propagates NaN as
// torch.amax does (fmaxf drops it), so a row with a NaN difference is never
// kept. max, abs and > are exact, so the keep
// bits equal the plain version's bitwise.
//
// Plain C interface, loaded with ctypes; each launcher returns the CUDA
// error of its launch so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"
#include "patch_tile.cuh"

namespace {

using namespace repro_torch::patch_tile;
using repro_torch::gelu_tanh;
using repro_torch::takes_first_max;

constexpr int WARPS = THREADS / 32;
constexpr int GATE_CHUNKS = 6;  // 16-byte chunks of each input a lane takes a pass
constexpr int GATE_ROWS = 8;   // most rows (warps) a delta_gate CTA
constexpr int SMEM_BYTES = 4 * (Q_FLOATS + RING_FLOATS + W_FLOATS) + 4 * (RT + 1);

__global__ void __launch_bounds__(THREADS, 2)
fused_step_kernel(const float* __restrict__ q,       // [B, n, H, DH]
                  const float* __restrict__ k_new,   // [B, H, C, DH]
                  const float* __restrict__ k_old,   // [B, H, C, DH]
                  const float* __restrict__ vc_new,  // [B, H, C, QC]
                  const float* __restrict__ vc_old,  // [B, H, C, QC]
                  const float* __restrict__ mask,    // [B, n, C]
                  const float* __restrict__ t_base,  // [B, n, H, QC]
                  const float* __restrict__ counts,  // [B, n]
                  const float* __restrict__ vq_bias, // [hq, QC]
                  float* __restrict__ t_out,         // [B, n, H, QC]
                  int* __restrict__ codes,           // [B, n, hq]
                  int* __restrict__ arrived,         // [B, ceil(n / RT), hq], zero
                  int n, int H, int C, int g, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [RT][PAD]: q, then T_base
  float* ring = q_s + Q_FLOATS;       // [2][4][CT][PAD]
  float* w_s = ring + RING_FLOATS;    // [2][CT][WS]
  int* row_live = reinterpret_cast<int*>(w_s + W_FLOATS);  // [RT]
  int* is_last = row_live + RT;

  const int h = blockIdx.y;           // attention head
  const int hh = h / g;               // its vq head
  const int hq = H / g;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * RT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nt = (C + CT - 1) / CT;
  const float* mask_b = mask + (size_t)b * n * C;
  const size_t col0 = ((size_t)b * H + h) * C;  // first column of (b, h)

  auto stage = [&](int t, int s) {  // copy column tile t into ring slot s
    const int c0 = t * CT;
#pragma unroll
    for (int a = 0; a < 4; ++a) {  // CT columns x 16 chunks of 16 bytes each
      const float* src = (a == 0 ? k_new : a == 1 ? k_old : a == 2 ? vc_new : vc_old)
                         + col0 * DH;
#pragma unroll
      for (int k = 0; k < CT * 16 / THREADS; ++k) {
        const int e = tid + k * THREADS;
        const int c = e / 16, d4 = e % 16;
        const bool ok = c0 + c < C;
        cp_async16(ring + s * STAGE_FLOATS + (a * CT + c) * PAD + 4 * d4,
                   src + (size_t)(ok ? c0 + c : 0) * DH + 4 * d4, ok);
      }
    }
  };
  // the tile's rows of a [B, n, H, DH] array at head h into q_s, zero past n
  auto stage_rows = [&](const float* src) {
#pragma unroll
    for (int k = 0; k < RT * 16 / THREADS; ++k) {
      const int e = tid + k * THREADS;
      const int r = e / 16, d4 = e % 16;
      const int row = row0 + r;
      const bool ok = row < n;
      cp_async16(q_s + r * PAD + 4 * d4,
                 src + (((size_t)b * n + (ok ? row : 0)) * H + h) * DH + 4 * d4, ok);
    }
  };

  // ---- does any row of the tile have a live column? (stops at the first
  // chunk of the mask that holds one: at once for a live tile)
  if (tid < RT) row_live[tid] = 0;
  bool tile_live = false;
  {
    const size_t len = (size_t)min(RT, n - row0) * C;
    const float* mt = mask_b + (size_t)row0 * C;
    for (size_t base = 0; base < len && !tile_live; base += 8 * THREADS) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const size_t e = base + tid + k * THREADS;
        any |= e < len && __ldg(mt + e) != 0.0f;
      }
      tile_live = __syncthreads_or(any);
    }
  }

  // A thread works on one product, mat (0 new, 1 old), at (sr, sc) of a
  // 16 x 8 grid. S (phases A, B): rows 4 sr + i, columns sc + 8 j; a
  // quarter warp shares sr (broadcast q loads) and reads 8 k columns a step.
  // dT (phase C, epilogue): rows 4 sr + i, codes 4 sc + e and 32 + 4 sc + e
  // (2.7 FMAs a loaded float); a quarter warp shares sr (a broadcast W
  // load) and reads 128 contiguous bytes of vc.
  const int mat = tid / (2 * RT);
  const int sr = (tid % (2 * RT)) / 8, sc = tid % 8;

  const int t_end = tile_live ? nt : 0;
  if (t_end == 0) {
    stage_rows(t_base);
  } else {
    stage_rows(q);
    stage(0, 0);
  }
  cp_async_commit();

  float acc[4][8];  // dT of product mat
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  for (int t = 0; t < t_end; ++t) {
    const int s = t & 1;
    const bool last = t + 1 == t_end;
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
        m[i][j] = (row < n && c < C) ? __ldg(mask_b + (size_t)row * C + c) : 0.0f;
        any |= m[i][j] != 0.0f;
      }
    cp_async_wait<0>();  // tile t (and the q tile) have landed
    // every thread is done with tile t - 1 (ring slot s ^ 1 and W are free);
    // a dead (row tile, column tile) pair skips both products
    const bool live = __syncthreads_or(any);
    if (!last) stage(t + 1, s ^ 1);  // in flight while this tile is used
    cp_async_commit();
    if (!live) {
      if (last) {  // T_base replaces q, its read overlapping the last tile
        stage_rows(t_base);
        cp_async_commit();
      }
    } else {
      // ---- phase A: S (new or old) for rows 4 sr + i, columns sc + 8 j
      float acc_s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_s[i][j] = 0.0f;
      const float* q_r = q_s + 4 * sr * PAD;
      const float* k_c = ring + s * STAGE_FLOATS + (mat * CT + sc) * PAD;
      switch ((ct + 7) / 8) {  // the column groups that hold a column
        case 4: s_product<4>(q_r, k_c, acc_s); break;
        case 3: s_product<3>(q_r, k_c, acc_s); break;
        case 2: s_product<2>(q_r, k_c, acc_s); break;
        default: s_product<1>(q_r, k_c, acc_s); break;
      }
      // ---- phase B: W = gelu(scale S) m, once per (row, column), to W^T
      // as float4 over the thread's 4 rows; a row with a live column is
      // marked
      float* wt = w_s + mat * CT * WS + 4 * sr;
      float wv[4][4];
      bool row_any[4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float mm = m[i][j];
          row_any[i] |= mm != 0.0f;
          wv[j][i] = gelu_tanh(acc_s[i][j] * scale) * mm;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st4(wt + (sc + 8 * j) * WS, make_float4(wv[j][0], wv[j][1], wv[j][2], wv[j][3]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (row_any[i]) row_live[4 * sr + i] = 1;  // racing stores of one value
      __syncthreads();  // W is whole; q_s is free
      if (last) {  // T_base replaces q, its read overlapping phase C
        stage_rows(t_base);
        cp_async_commit();
      }

      // ---- phase C: dT += W vc for product mat
      const float* vt = ring + s * STAGE_FLOATS + (2 + mat) * CT * PAD + 4 * sc;
      const float* wt_c = w_s + mat * CT * WS + 4 * sr;
#pragma unroll 8
      for (int c = 0; c < ct; ++c) {
        const float4 w = ld4(wt_c + c * WS);
        const float4 v0 = ld4(vt + c * PAD), v1 = ld4(vt + c * PAD + 32);
        const float wr[4] = {w.x, w.y, w.z, w.w};
        const float vr[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(wr[i], vr[e], acc[i][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // T_base is in q_s; the ring is free

  // ---- epilogue: the old product's threads leave dT_old in shared memory
  // (the free ring); the new product's write T = T_base + (dT_new -
  // dT_old), or T_base itself for a row with no live column (so -0.0 keeps
  // its sign)
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
  if (mat == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * sr + i;
      const int row = row0 + r;
      if (row >= n) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int code = 4 * sc + 32 * half;
        float4 tv = ld4(q_s + r * PAD + code);  // T_base
        if (row_live[r]) {
          const float4 od = ld4(dold_s + r * PAD + code);
          tv.x += acc[i][4 * half + 0] - od.x;
          tv.y += acc[i][4 * half + 1] - od.y;
          tv.z += acc[i][4 * half + 2] - od.z;
          tv.w += acc[i][4 * half + 3] - od.w;
        }
        st4(t_out + (((size_t)b * n + row) * H + h) * QC + code, tv);
      }
    }
  }

  // ---- requantize: the last of the g CTAs of (row tile, vq head) to
  // finish sums their T rows in head order j = 0..g-1 (read from L2) and
  // takes the first maximum; the others leave at once. It resets the
  // arrival count, so the next launch finds it zero again.
  __threadfence();  // this CTA's T is visible before its arrival counts
  __syncthreads();
  if (tid == 0) {
    int* cnt = arrived + ((size_t)b * gridDim.x + blockIdx.x) * hq + hh;
    *is_last = atomicAdd(cnt, 1) == g - 1;
    if (*is_last) *cnt = 0;
  }
  __syncthreads();
  if (!*is_last) return;
  __threadfence();  // the other CTAs' T, seen after their arrivals
  constexpr int RPW = RT / WARPS;  // rows of a warp
  float v0[RPW], v1[RPW];
  for (int j = 0; j < g; ++j) {  // loads of one head for all rows, then the sums
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int row = min(row0 + warp * RPW + k, n - 1);
      const float* tr_j = t_out + (((size_t)b * n + row) * H + hh * g + j) * QC;
      const float a0 = __ldcg(tr_j + lane), a1 = __ldcg(tr_j + lane + 32);
      v0[k] = j == 0 ? a0 : v0[k] + a0;
      v1[k] = j == 0 ? a1 : v1[k] + a1;
    }
  }
  const float bias0 = vq_bias[hh * QC + lane], bias1 = vq_bias[hh * QC + lane + 32];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int row = row0 + warp * RPW + k;
    if (row >= n) break;  // warp-uniform
    const float cnt = counts[(size_t)b * n + row];
    const float s0 = v0[k] / cnt + bias0;
    const float s1 = v1[k] / cnt + bias1;
    float best = s0;
    int best_idx = lane;
    if (s1 > best) {  // strict: the lower code keeps a tie
      best = s1;
      best_idx = lane + 32;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
      if (takes_first_max(ob, oi, best, best_idx)) {
        best = ob;
        best_idx = oi;
      }
    }
    if (lane == 0) codes[((size_t)b * n + row) * hq + hh] = best_idx;
  }
}

// |a - o| as the bits of a float with the sign cleared: as unsigned
// integers they order as the floats do, and every NaN lies above +inf.
__device__ __forceinline__ unsigned abs_diff_bits(float a, float o) {
  return __float_as_uint(a - o) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned fold(unsigned m, float4 a, float4 o) {
  m = max(m, abs_diff_bits(a.x, o.x));
  m = max(m, abs_diff_bits(a.y, o.y));
  m = max(m, abs_diff_bits(a.z, o.z));
  return max(m, abs_diff_bits(a.w, o.w));
}

template <bool BURST>
__global__ void __launch_bounds__(GATE_ROWS * 32)
delta_gate_kernel(const float* __restrict__ x_new,  // [r, d]
                  const float* __restrict__ x_old,  // [r, d]
                  unsigned char* __restrict__ keep, // [r] bool
                  int r, int d, float threshold, bool vec) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= r) return;  // warp-uniform: the shuffles below see a full warp
  const float* a = x_new + (size_t)row * d;
  const float* o = x_old + (size_t)row * d;
  unsigned m = 0;  // the bits of max |diff| so far (of NaN once one is seen)
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* o4 = reinterpret_cast<const float4*>(o);
    const int n4 = d / 4;
    for (int base = lane; base < n4; base += GATE_CHUNKS * 32) {
      float4 va[GATE_CHUNKS], vo[GATE_CHUNKS];
#pragma unroll
      for (int k = 0; k < GATE_CHUNKS; ++k) {
        const int c = base + k * 32;
        if (!BURST) {  // past the row's end, a chunk again: the max stays
          va[k] = __ldg(a4 + min(c, n4 - 1));
          vo[k] = __ldg(o4 + min(c, n4 - 1));
        } else if (c < n4) {
          va[k] = __ldg(a4 + c);
          vo[k] = __ldg(o4 + c);
        }
      }
#pragma unroll
      for (int k = 0; k < GATE_CHUNKS; ++k)
        if (!BURST || base + k * 32 < n4) m = fold(m, va[k], vo[k]);
    }
  } else {
    for (int i = lane; i < d; i += 32) m = max(m, abs_diff_bits(a[i], o[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) keep[row] = (__uint_as_float(m) > threshold) ? 1 : 0;  // NaN > t is false
}

}  // namespace

extern "C" int fused_step_launch(const float* q, const float* k_new,
                                 const float* k_old, const float* vc_new,
                                 const float* vc_old, const float* mask,
                                 const float* t_base, const float* counts,
                                 const float* vq_bias, float* t_out, int* codes,
                                 int* arrived, int B, int n, int H, int C, int g,
                                 float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + RT - 1) / RT, H, B);
  fused_step_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      q, k_new, k_old, vc_new, vc_old, mask, t_base, counts, vq_bias, t_out,
      codes, arrived, n, H, C, g, scale);
  return (int)cudaGetLastError();
}

extern "C" int delta_gate_launch(const float* x_new, const float* x_old,
                                 unsigned char* keep, int r, int d,
                                 float threshold, int rows_per_cta, int burst,
                                 cudaStream_t stream) {
  if (rows_per_cta < 1 || rows_per_cta > GATE_ROWS) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(x_new) % 16 == 0 &&
                   reinterpret_cast<size_t>(x_old) % 16 == 0;
  const dim3 grid((r + rows_per_cta - 1) / rows_per_cta);
  if (burst)
    delta_gate_kernel<true><<<grid, rows_per_cta * 32, 0, stream>>>(
        x_new, x_old, keep, r, d, threshold, vec);
  else
    delta_gate_kernel<false><<<grid, rows_per_cta * 32, 0, stream>>>(
        x_new, x_old, keep, r, d, threshold, vec);
  return (int)cudaGetLastError();
}
