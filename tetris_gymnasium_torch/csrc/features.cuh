// The feature vector of a cropped 20x10 playfield, as device code shared by
// the feature_vector kernel (features.cu) and the grouped_flagship kernel's
// features mode (grouped_flagship.cu).
//
// Replaces tetris_gymnasium_tpu/ops/observations.py:feature_vector (:57)
// with column_heights (:17), max_height (:29), bumpiness (:34) and holes
// (:40): a cell counts as filled where its id is not 0.  The rows come in
// top-down as 10-bit masks (bit c = column c filled); the accumulator keeps
// nothing of the board but bit-sliced height counters: adding the running OR
// of the rows seen so far into five bit planes counts, for every column at
// once, the rows at or below its top, which is its height (at most 20 < 32).
// Holes are the sum of the heights less the filled cells.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace features {

constexpr int FH = 20;      // playfield rows
constexpr int FW = 10;      // playfield columns
constexpr int kPlanes = 5;  // bit planes of the height counters
constexpr uint32_t ROW_MASK = (1u << FW) - 1u;

// FeatureFlags as bits, in the order of the vector's parts.
enum : int { kHeight = 1, kMaxHeight = 2, kHoles = 4, kBumpiness = 8 };

__host__ __device__ constexpr int n_features(int flags) {
  return ((flags & kHeight) ? FW : 0) + ((flags & kMaxHeight) ? 1 : 0) + ((flags & kHoles) ? 1 : 0) +
         ((flags & kBumpiness) ? 1 : 0);
}

struct Acc {
  uint32_t planes[kPlanes];
  uint32_t seen;  // columns filled in some row so far
  int occupied;   // filled cells so far

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) planes[j] = 0u;
    seen = 0u;
    occupied = 0;
  }

  // The next row down (rows above the first filled one may be skipped).
  __device__ __forceinline__ void add_row(uint32_t m) {
    seen |= m;
    occupied += __popc(m);
    uint32_t carry = seen;  // one more row at or below the top, for every column seen
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) {
      const uint32_t t = planes[j] & carry;
      planes[j] ^= carry;
      carry = t;
    }
  }

  __device__ __forceinline__ int height(int c) const {
    int h = 0;
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) h |= static_cast<int>((planes[j] >> c) & 1u) << j;
    return h;
  }

  // The vector under `flags`: heights, max height, holes, bumpiness.
  template <typename T>
  __device__ __forceinline__ void write(int flags, T* out) const {
    int h[FW];
    int max_h = 0, sum_h = 0, bump = 0;
#pragma unroll
    for (int c = 0; c < FW; ++c) {
      h[c] = height(c);
      max_h = max(max_h, h[c]);
      sum_h += h[c];
      if (c) bump += abs(h[c] - h[c - 1]);
    }
    int k = 0;
    if (flags & kHeight) {
#pragma unroll
      for (int c = 0; c < FW; ++c) out[k + c] = static_cast<T>(h[c]);
      k += FW;
    }
    if (flags & kMaxHeight) out[k++] = static_cast<T>(max_h);
    if (flags & kHoles) out[k++] = static_cast<T>(sum_h - occupied);
    if (flags & kBumpiness) out[k++] = static_cast<T>(bump);
  }
};

}  // namespace features
