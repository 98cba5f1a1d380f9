// Hand-written Hopper (sm_90a) kernel of multi-head VQ assignment.
//
// Replaces the TPU Pallas kernels of src/repro/kernels/vq_assign/vq_assign.py:
// vq_assign_kernel (pallas_call at :61) and vq_assign_kernel_batched (:103).
// For every token r of the flattened [B * N] tokens and vq head h:
//   scores[c] = x[r,h,:] . C[h,c,:] - ||C[h,c]||^2 / 2
//   idx[r,h] = argmax_c scores[c]                       (first maximum on ties)
//   xq[r,h,:] = C[h, idx[r,h], :]
// (paper App. A.2: the argmax of the inner-product form is the nearest code).
// One launcher for the unbatched (B = 1) and batched wrappers: x is
// [B, N, hq, dv] contiguous, so the tokens of all documents are one axis.
//
// What bounds it on an H100. The forward's call (B*N = 4096 tokens, hq = 2,
// Q = 64, dv = 384) is bytes: it reads x and writes xq, 12.6 MB each, 7.5 us
// at 3.35 TB/s, against 0.4 GFLOP of dot products, 6 us at the 67 TFLOP/s
// FP32 peak. A decode call (one token) and a prefill chunk are latency: a
// launch, one pass over the head's codebook (96 KB, L2-resident across calls:
// 2.3 MB for all 12 layers), and the barriers and reductions of one block.
//
// Two schedules; the wrapper picks one, and the large one's tile, by a fixed
// rule on the token count (kernels/vq_assign/ops.py, schedule):
// * small (decode and short prefill chunks, up to 384 tokens): one block per
//   (token, head), and nothing for tokens that do not exist. Its 8 warps
//   split the codes, 8 a warp at a time; the lanes stride over dv with
//   16-byte loads straight from L1/L2 (no staging, no barrier in the loop),
//   and each warp sums its 8 scores with __shfl_xor_sync. The block takes
//   the first maximum of the 8 warps' winners through shared memory.
// * large (long prefills and the forward): a register-tiled [tokens x 64
//   codes] product per block. Each thread owns TM tokens x 4 codes; the
//   block's threads are split into parts that take disjoint slices of every
//   dv chunk, and part 0 sums the others' partial products in a fixed order.
//   x and the codebook stream through a ring of dv chunks in dynamic shared
//   memory filled with cp.async (16 B), the next chunk in flight while this
//   one is used. Q > 64 loops over code tiles with a running first maximum.
//   Two tiles, each a schedule of its own: 16 tokens on 512 threads with
//   three 128-wide chunks up to 1,024 tokens (1,024 tokens at hq = 2 give 128
//   blocks for 132 SMs), and 32 tokens on 256 threads with three 64-wide
//   chunks above (half the blocks and codebook loads, two blocks an SM).
// Both compute the bias -||C||^2/2 in the kernel from the codebook rows they
// load anyway (no helper launches), in a fixed order that is the same for
// every code, so equal codebook rows give bitwise-equal scores and the lower
// index wins. Both take any Q <= 256 and dv >= 1: a dv that is not a
// multiple of 4, or an unaligned pointer, takes the scalar path (a template
// argument), and ragged token, code and dv edges are masked.
// xq is a direct indexed copy of the winning codebook row, not the TPU's
// one-hot matmul, so it is bitwise C[idx]. The dot products run on the FP32
// CUDA cores in full precision: TF32 tensor cores would flip codes.
//
// Measured with chip_smoke.py --sweep (device time by kernel name from
// torch.profiler, hq = 2, Q = 64, dv = 384; NVIDIA H100 80GB HBM3,
// 700.00 W): 0.0033 ms at 1 token, 0.0035 at 32, 0.0110 at 1,024, 0.0152 at
// 1,536 and 0.0234 at 4,096, against 0.2232 / 0.2308 / 0.2320 / 0.2325 /
// 0.2517 ms for the kernel it replaced (whose wrapper added 0.005 ms of bias
// kernels a call). What holds the large schedule above its bound is one
// block's latency: a single 16-token block (one token, the large schedule
// forced) takes 0.0087 ms, and 1,024 tokens (128 blocks) add 0.0023 ms to
// that; every block stages its head's whole codebook (96 KB: 12.6 MB from
// L2 at 1,024 tokens).
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::takes_first_max;

// ------------------------------------------------ small: a block a (token, head)

constexpr int S_WARPS = 8;
constexpr int S_THREADS = S_WARPS * 32;
constexpr int S_CODES = 8;  // codes a warp scores at once

template <bool VEC>
__global__ void __launch_bounds__(S_THREADS)
vq_assign_small(const float* __restrict__ x,   // [M, hq, dv]
                const float* __restrict__ cb,  // [hq, Q, dv]
                int* __restrict__ idx,         // [M, hq]
                float* __restrict__ xq,        // [M, hq, dv]
                int hq, int Q, int dv) {
  __shared__ float s_best[S_WARPS];
  __shared__ int s_idx[S_WARPS];
  const size_t row = blockIdx.x;  // token * hq + head
  const int h = (int)(row % hq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xr = x + row * dv;
  const float* cbh = cb + (size_t)h * Q * dv;

  float best = 0.0f;
  int best_idx = -1;
  for (int c0 = warp * S_CODES; c0 < Q; c0 += S_WARPS * S_CODES) {
    const float* rows[S_CODES];
#pragma unroll
    for (int k = 0; k < S_CODES; ++k)  // a code past Q reads row Q-1, never wins
      rows[k] = cbh + (size_t)min(c0 + k, Q - 1) * dv;
    float dot[S_CODES], sq[S_CODES];
#pragma unroll
    for (int k = 0; k < S_CODES; ++k) dot[k] = sq[k] = 0.0f;
    if (VEC) {
      const int nv = dv / 4;
#pragma unroll 2
      for (int v = lane; v < nv; v += 32) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(xr) + v);
#pragma unroll
        for (int k = 0; k < S_CODES; ++k) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(rows[k]) + v);
          dot[k] = fmaf(a.x, w.x, dot[k]);
          dot[k] = fmaf(a.y, w.y, dot[k]);
          dot[k] = fmaf(a.z, w.z, dot[k]);
          dot[k] = fmaf(a.w, w.w, dot[k]);
          sq[k] = fmaf(w.x, w.x, sq[k]);
          sq[k] = fmaf(w.y, w.y, sq[k]);
          sq[k] = fmaf(w.z, w.z, sq[k]);
          sq[k] = fmaf(w.w, w.w, sq[k]);
        }
      }
    } else {
      for (int d = lane; d < dv; d += 32) {
        const float a = __ldg(xr + d);
#pragma unroll
        for (int k = 0; k < S_CODES; ++k) {
          const float w = __ldg(rows[k] + d);
          dot[k] = fmaf(a, w, dot[k]);
          sq[k] = fmaf(w, w, sq[k]);
        }
      }
    }
    float s[S_CODES];
#pragma unroll
    for (int k = 0; k < S_CODES; ++k) s[k] = fmaf(-0.5f, sq[k], dot[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < S_CODES; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    }
#pragma unroll
    for (int k = 0; k < S_CODES; ++k) {  // codes increase: strict > keeps the first
      if (c0 + k < Q && (best_idx < 0 || s[k] > best)) {
        best = s[k];
        best_idx = c0 + k;
      }
    }
  }
  if (lane == 0) {
    s_best[warp] = best;
    s_idx[warp] = best_idx;
  }
  __syncthreads();
  best = s_best[0];
  best_idx = s_idx[0];
#pragma unroll
  for (int w = 1; w < S_WARPS; ++w) {
    if (takes_first_max(s_best[w], s_idx[w], best, best_idx)) {
      best = s_best[w];
      best_idx = s_idx[w];
    }
  }
  if (threadIdx.x == 0) idx[row] = best_idx;
  const float* src = cbh + (size_t)best_idx * dv;
  float* dst = xq + row * dv;
  if (VEC) {
    for (int v = threadIdx.x; v < dv / 4; v += S_THREADS)
      reinterpret_cast<float4*>(dst)[v] = __ldg(reinterpret_cast<const float4*>(src) + v);
  } else {
    for (int d = threadIdx.x; d < dv; d += S_THREADS) dst[d] = __ldg(src + d);
  }
}

// ------------------------------------------------ large: register-tiled product

constexpr int L_CODES = 64;           // codes a tile (a loop covers Q)
constexpr int L_TN = 4;               // codes a thread: tx, tx + 16, tx + 32, tx + 48
constexpr int L_TX = L_CODES / L_TN;  // 16 threads across the codes

// A tile shape of the large schedule: TM tokens x 4 codes a thread, TYG
// token groups (BM = TM * TYG tokens a block), the block's THREADS threads in
// SPLIT parts that each take DK / SPLIT of every DK-wide dv chunk, and a ring
// of STAGES chunks in dynamic shared memory.
template <int TM_, int TYG_, int THREADS_, int STAGES_, int DK_>
struct Tile {
  static constexpr int TM = TM_, TYG = TYG_, THREADS = THREADS_, STAGES = STAGES_, DK = DK_;
  static constexpr int BM = TM * TYG;
  static constexpr int PART = L_TX * TYG;  // threads of one [BM x 64] product
  static constexpr int SPLIT = THREADS / PART;
  static constexpr int KS = DK / SPLIT;
  static constexpr int PAD = DK + 4;  // shared row stride: 16-byte rows, no bank conflicts
  static constexpr int SLOT = (BM + L_CODES) * PAD;
  static constexpr int SMEM = STAGES * SLOT * (int)sizeof(float);
  static constexpr int NSTRIDE = PART / L_CODES;  // every NSTRIDE-th thread of a part sums a norm
  static_assert(KS % 4 == 0 && PART % L_CODES == 0 && THREADS % PART == 0, "tile shape");
  static_assert((SPLIT - 1) * TM * L_TN * PART <= STAGES * SLOT,
                "the partial sums fit in the ring");
};
// 16 tokens: 1,024 tokens at hq = 2 give 128 blocks for 132 SMs
using Tile16 = Tile<2, 8, 512, 3, 128>;
// 32 tokens: half the blocks and half the codebook loads of Tile16, and a
// 78 KB ring that lets two blocks share an SM
using Tile32 = Tile<4, 8, 256, 3, 64>;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage dv chunk kc of the block's tokens (rows [0, BM) of the slot) and of
// codes [q0, q0 + 64) (rows [BM, BM + 64)) into a ring slot; what lies past
// M, Q or dv is zero (0 * 0 adds nothing to a dot product or a squared norm).
template <class T, bool VEC>
__device__ __forceinline__ void stage(float* slot, const float* __restrict__ x,
                                      const float* __restrict__ cbh, int tok0, int q0,
                                      int kc, int M, int hq, int h, int Q, int dv) {
  const int k0 = kc * T::DK;
  if (VEC) {
    constexpr int V = T::DK / 4, ROWS = T::THREADS / 16;  // 16 lanes a row
    const int r0 = threadIdx.x / 16, lane = threadIdx.x % 16;
    for (int r = r0; r < T::BM + L_CODES; r += ROWS) {
      const bool tok = r < T::BM;
      const int id = tok ? tok0 + r : q0 + r - T::BM;
      const bool live = tok ? id < M : id < Q;
      const float* src = tok ? x + ((size_t)id * hq + h) * dv : cbh + (size_t)id * dv;
      float* dst = slot + r * T::PAD - k0;
#pragma unroll
      for (int v = lane; v < V; v += 16) {
        const int d = k0 + 4 * v;
        if (live && d < dv)
          cp_async16(dst + d, src + d);
        else
          *reinterpret_cast<float4*>(dst + d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < (T::BM + L_CODES) * T::DK; e += T::THREADS) {
      const int r = e / T::DK, d = k0 + e % T::DK;
      const bool tok = r < T::BM;
      const int id = tok ? tok0 + r : q0 + r - T::BM;
      const float* src = tok ? x + ((size_t)id * hq + h) * dv : cbh + (size_t)id * dv;
      slot[r * T::PAD + d - k0] = ((tok ? id < M : id < Q) && d < dv) ? __ldg(src + d) : 0.0f;
    }
  }
}

// acc[i][j] += a[i].f * w[j].f for one float4 component f, the accumulators
// in turn (no two dependent FMAs back to back)
#define VQ_OUTER(f)                                  \
  _Pragma("unroll") for (int i = 0; i < T::TM; ++i)    \
  _Pragma("unroll") for (int j = 0; j < L_TN; ++j)     \
      acc[i][j] = fmaf(a[i].f, w[j].f, acc[i][j]);

template <class T, bool VEC>
__global__ void __launch_bounds__(T::THREADS)
vq_assign_large(const float* __restrict__ x,   // [M, hq, dv]
                const float* __restrict__ cb,  // [hq, Q, dv]
                int* __restrict__ idx,         // [M, hq]
                float* __restrict__ xq,        // [M, hq, dv]
                int M, int hq, int Q, int dv) {
  extern __shared__ __align__(16) float smem[];  // the ring: STAGES x ([BM] + [64]) rows
  __shared__ float s_sq[T::SPLIT][L_CODES];  // each part's share of ||C||^2
  __shared__ float s_bias[L_CODES];

  const int h = blockIdx.y;
  const int tok0 = blockIdx.x * T::BM;
  const int part = threadIdx.x / T::PART;  // dv [part KS, (part + 1) KS) of each chunk
  const int t = threadIdx.x % T::PART;
  const int tx = t % L_TX;  // codes tx + 16 j of a tile
  const int ty = t / L_TX;  // tokens TM ty .. TM ty + TM - 1 of the block
  const bool norms = t % T::NSTRIDE == 0;  // ||C[q0 + t / NSTRIDE]||^2 over the part's dv
  const float* cbh = cb + (size_t)h * Q * dv;
  const int nk = (dv + T::DK - 1) / T::DK;

  float best[T::TM];
  int best_idx[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    best[i] = 0.0f;
    best_idx[i] = -1;
  }

  for (int q0 = 0; q0 < Q; q0 += L_CODES) {
    float acc[T::TM][L_TN];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < L_TN; ++j) acc[i][j] = 0.0f;
    float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four chains, summed in a fixed order

#pragma unroll
    for (int s = 0; s < T::STAGES - 1; ++s) {
      if (s < nk) stage<T, VEC>(smem + s * T::SLOT, x, cbh, tok0, q0, s, M, hq, h, Q, dv);
      cp_async_commit();  // one group a slot, empty or not, keeps the count
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<T::STAGES - 2>();  // chunk kc has landed
      __syncthreads();  // ... for every thread; and chunk kc - 1's slot is free
      const int next = kc + T::STAGES - 1;
      if (next < nk)
        stage<T, VEC>(smem + (next % T::STAGES) * T::SLOT, x, cbh, tok0, q0, next, M, hq, h,
                      Q, dv);
      cp_async_commit();
      const float* xs = smem + (kc % T::STAGES) * T::SLOT;
      const float* cs = xs + T::BM * T::PAD;
#pragma unroll 4
      for (int kk = 0; kk < T::KS; kk += 4) {
        const int k = part * T::KS + kk;
        float4 a[T::TM], w[L_TN];
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + (ty * T::TM + i) * T::PAD + k);
#pragma unroll
        for (int j = 0; j < L_TN; ++j)
          w[j] = *reinterpret_cast<const float4*>(cs + (tx + L_TX * j) * T::PAD + k);
        VQ_OUTER(x)
        VQ_OUTER(y)
        VQ_OUTER(z)
        VQ_OUTER(w)
      }
      if (norms) {
#pragma unroll 4
        for (int kk = 0; kk < T::KS; kk += 4) {
          const float4 w = *reinterpret_cast<const float4*>(
              cs + (t / T::NSTRIDE) * T::PAD + part * T::KS + kk);
          sq[0] = fmaf(w.x, w.x, sq[0]);
          sq[1] = fmaf(w.y, w.y, sq[1]);
          sq[2] = fmaf(w.z, w.z, sq[2]);
          sq[3] = fmaf(w.w, w.w, sq[3]);
        }
      }
    }
    // the other parts hand their partial sums to part 0 through the ring
    cp_async_wait<0>();
    __syncthreads();
    float* red = smem;  // [SPLIT - 1][TM * 4][PART]
    if (part > 0) {
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < L_TN; ++j)
          red[((part - 1) * T::TM * L_TN + i * L_TN + j) * T::PART + t] = acc[i][j];
    }
    if (norms) s_sq[part][t / T::NSTRIDE] = (sq[0] + sq[1]) + (sq[2] + sq[3]);
    __syncthreads();
    if (threadIdx.x < L_CODES) {  // the parts in order: the same sum for every code
      float norm = s_sq[0][threadIdx.x];
#pragma unroll
      for (int p = 1; p < T::SPLIT; ++p) norm += s_sq[p][threadIdx.x];
      s_bias[threadIdx.x] = -0.5f * norm;
    }
    __syncthreads();
    if (part == 0) {
      float sc[T::TM][L_TN];
#pragma unroll
      for (int j = 0; j < L_TN; ++j) {
        const float bias = s_bias[tx + L_TX * j];
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          float s = acc[i][j];
#pragma unroll
          for (int p = 1; p < T::SPLIT; ++p)
            s += red[((p - 1) * T::TM * L_TN + i * L_TN + j) * T::PART + t];
          sc[i][j] = s + bias;
        }
      }
#pragma unroll
      for (int j = 0; j < L_TN; ++j) {  // a lane's codes increase: strict > keeps the first
        const int c = q0 + tx + L_TX * j;
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          if (c < Q && (best_idx[i] < 0 || sc[i][j] > best[i])) {
            best[i] = sc[i][j];
            best_idx[i] = c;
          }
        }
      }
    }
    __syncthreads();  // the ring, s_sq and s_bias are refilled by the next code tile
  }
  if (part > 0) return;

  // the 16 threads of a token group are adjacent lanes: butterfly over them
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
#pragma unroll
    for (int off = 1; off < L_TX; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
      if (takes_first_max(ob, oi, best[i], best_idx[i])) {
        best[i] = ob;
        best_idx[i] = oi;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int tok = tok0 + ty * T::TM + i;
    if (tok >= M) continue;
    const size_t row = (size_t)tok * hq + h;
    if (tx == 0) idx[row] = best_idx[i];
    const float* src = cbh + (size_t)best_idx[i] * dv;
    float* dst = xq + row * dv;
    if (VEC) {
#pragma unroll 4
      for (int v = tx; v < dv / 4; v += L_TX)
        reinterpret_cast<float4*>(dst)[v] = __ldg(reinterpret_cast<const float4*>(src) + v);
    } else {
      for (int d = tx; d < dv; d += L_TX) dst[d] = __ldg(src + d);
    }
  }
}

#undef VQ_OUTER

template <class T, bool VEC>
cudaError_t launch_large(const float* x, const float* cb, int* idx, float* xq, int M, int hq,
                         int Q, int dv, cudaStream_t stream) {
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      vq_assign_large<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T::BM - 1) / T::BM, hq);
  vq_assign_large<T, VEC><<<grid, T::THREADS, T::SMEM, stream>>>(x, cb, idx, xq, M, hq, Q, dv);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_tile(bool vec, const float* x, const float* cb, int* idx, float* xq, int M,
                         int hq, int Q, int dv, cudaStream_t stream) {
  return vec ? launch_large<T, true>(x, cb, idx, xq, M, hq, Q, dv, stream)
             : launch_large<T, false>(x, cb, idx, xq, M, hq, Q, dv, stream);
}

}  // namespace

// x [M, hq, dv], codebook [hq, Q, dv] -> idx [M, hq], xq [M, hq, dv], with
// M = B * N tokens. ``schedule`` is the wrapper's choice (ops.py, SCHEDULES):
// 0 small, 1 large with 16-token tiles, 2 large with 32-token tiles.
extern "C" int vq_assign_launch(const float* x, const float* cb, int* idx, float* xq,
                                int M, int hq, int Q, int dv, int schedule,
                                cudaStream_t stream) {
  const bool vec = dv % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)cb | (uintptr_t)xq) & 15) == 0;
  switch (schedule) {
    case 0: {
      const unsigned blocks = (unsigned)((size_t)M * hq);
      if (vec)
        vq_assign_small<true><<<blocks, S_THREADS, 0, stream>>>(x, cb, idx, xq, hq, Q, dv);
      else
        vq_assign_small<false><<<blocks, S_THREADS, 0, stream>>>(x, cb, idx, xq, hq, Q, dv);
      return (int)cudaGetLastError();
    }
    case 1:
      return (int)launch_tile<Tile16>(vec, x, cb, idx, xq, M, hq, Q, dv, stream);
    case 2:
      return (int)launch_tile<Tile32>(vec, x, cb, idx, xq, M, hq, Q, dv, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
