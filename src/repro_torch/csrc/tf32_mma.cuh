// The 3xTF32 tensor-core route of the attention kernels, shared by
// gated_attention.cu (the forward) and gated_attention_bwd.cu (its gradient):
// mma.sync.m16n8k8 TF32 products with FP32 accumulation, each f32 operand x
// split as big = x rounded to TF32 and small = x - big, each product taken
// as small*big + big*small + big*big (~21 bits of the operands).
//
// Fragments of one m16n8k8 tile, g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <stdint.h>

namespace repro_torch {
namespace tf32 {

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

}  // namespace tf32
}  // namespace repro_torch
