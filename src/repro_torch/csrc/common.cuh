// Device helpers shared by the port's hand-written kernels.
#pragma once

#include <math.h>

namespace repro_torch {

// tanh-approximate GELU, the form of torch's F.gelu(approximate="tanh") and
// jax.nn.gelu(approximate=True)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

// First-maximum merge of two (score, index) candidates, as torch.argmax and
// jnp.argmax break ties: true when (other, other_idx) should replace
// (best, best_idx). An index < 0 marks an empty candidate.
__device__ __forceinline__ bool takes_first_max(float other, int other_idx,
                                                float best, int best_idx) {
  if (other_idx < 0) return false;
  if (best_idx < 0) return true;
  return other > best || (other == best && other_idx < best_idx);
}

}  // namespace repro_torch
