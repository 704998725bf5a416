// JAX's random bits on the card: threefry-2x32 and its float32 uniform.
//
// Shared by sample_group.cuh (ppo_sample.cu and the sampling builds of
// turbo_step.cu and flagship_step.cu), grouped_act.cu, replay.cu,
// dqn_act.cu and fn_env.cu.  Under
// jax_threefry_partitionable, jax.random.bits(key, shape) at row-major flat
// index i is y0 ^ y1 of one 20-round threefry-2x32 block of the key at
// counter [0, i] (i < 2**32 here), and jax.random.uniform puts the top 23
// bits into the mantissa of a float in [1, 2), subtracts 1, scales to
// [minval, maxval) and clamps at minval.  The host twins are in
// tetris_gymnasium_torch/ops/threefry.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf {

constexpr float kTiny = 1.17549435e-38f;  // float32 tiny: gumbel's minval

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Both words (y0, y1) of one 20-round threefry-2x32 block of key (k0, k1) at
// counter (c0, c1): jax.random.split(key, n)[i] is the block at (0, i).
__device__ __forceinline__ uint2 block(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  return make_uint2(x0, x1);
}

// y0 ^ y1 of one block: jax.random.bits at counter (c0, c1).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1) {
  const uint2 y = block(k0, k1, c0, c1);
  return y.x ^ y.y;
}

// JAX's float32 uniform in [lo, lo + scale) from 32 random bits, where
// scale = float32(maxval) - float32(minval); _rn intrinsics keep the multiply
// and the add apart, as XLA and PyTorch round them.
__device__ __forceinline__ float uniform(uint32_t b, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, scale), lo));
}

// jax.random.gumbel's uniform (mode "low"): in [tiny, 1), scale float32(1 - tiny) = 1.
__device__ __forceinline__ float gumbel_uniform(uint32_t b) { return uniform(b, kTiny, 1.0f); }

// -log(-log(u)), with the logf that PyTorch's log calls.
__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(u)); }

}  // namespace tf
