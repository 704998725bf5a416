// The feature vector of a cropped FH x FW playfield, as device code shared
// by the feature_vector kernel (features.cu) and the features modes of the
// grouped kernels (grouped_flagship.cu, grouped_placements.cu).
//
// Replaces tetris_gymnasium_tpu/ops/observations.py:feature_vector (:57)
// with column_heights (:17), max_height (:29), bumpiness (:34) and holes
// (:40): a cell counts as filled where its id is not 0.  The rows come in
// top-down as FW-bit masks in NWF = ceil(FW / 32) words (bit c % 32 of word
// c / 32 = column c filled); the accumulator keeps nothing of the board but
// bit-sliced height counters: adding the running OR of the rows seen so far
// into kPlanes bit planes (enough to count to FH) counts, for every column
// at once, the rows at or below its top, which is its height.  Holes are
// the sum of the heights less the filled cells.
//
// The geometry is a pair of template arguments, so that each caller's build
// (kernels.py: one library per geometry) unrolls every loop over constant
// indices: at the default 20 x 10 crop a row is one word and the counters
// five planes, the single-word code of the first build.  Limits: FH <= 64
// (7 planes) and FW <= 128 (4 words a row), which every crop of a padded
// board within kernels.py:engine_defines' limits meets.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace features {

// FeatureFlags as bits, in the order of the vector's parts.
enum : int { kHeight = 1, kMaxHeight = 2, kHoles = 4, kBumpiness = 8, kAll = 15 };

__host__ __device__ constexpr int n_features(int width, int flags) {
  return ((flags & kHeight) ? width : 0) + ((flags & kMaxHeight) ? 1 : 0) +
         ((flags & kHoles) ? 1 : 0) + ((flags & kBumpiness) ? 1 : 0);
}

// Bits of a counter that reaches n.
__host__ __device__ constexpr int counter_bits(int n) { return n < 2 ? 1 : 1 + counter_bits(n / 2); }

// Word k of the mask of a full FW-column row.
template <int FW>
__host__ __device__ constexpr uint32_t full_row_word(int k) {
  return (32 * k + 32 <= FW) ? 0xFFFFFFFFu : ((1u << (FW - 32 * k)) - 1u);
}

// The FW playfield bits of a padded row of NWP words that start at padded
// column PAD, as a row mask (bit c of the result = padded column PAD + c).
template <int NWP, int PAD, int FW>
__device__ __forceinline__ void crop_row(const uint32_t (&row)[NWP], uint32_t (&m)[(FW + 31) / 32]) {
#pragma unroll
  for (int k = 0; k < (FW + 31) / 32; ++k) {
    const int w0 = (PAD + 32 * k) / 32, s = (PAD + 32 * k) % 32;
    uint32_t v = row[w0] >> s;
    if (s != 0 && w0 + 1 < NWP) v |= row[w0 + 1] << (32 - s);
    m[k] = v & full_row_word<FW>(k);
  }
}

template <int FH, int FW>
struct Acc {
  static_assert(FH >= 1 && FH <= 64 && FW >= 1 && FW <= 128, "features.cuh: FH <= 64, FW <= 128");
  static constexpr int NWF = (FW + 31) / 32;   // words of a row mask
  static constexpr int kPlanes = counter_bits(FH);

  uint32_t planes[kPlanes][NWF];
  uint32_t seen[NWF];  // columns filled in some row so far
  int occupied;        // filled cells so far

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < NWF; ++k) {
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) planes[j][k] = 0u;
      seen[k] = 0u;
    }
    occupied = 0;
  }

  // The next row down (rows above the first filled one may be skipped).
  __device__ __forceinline__ void add_row(const uint32_t (&m)[NWF]) {
#pragma unroll
    for (int k = 0; k < NWF; ++k) {
      seen[k] |= m[k];
      occupied += __popc(m[k]);
      uint32_t carry = seen[k];  // one more row at or below the top, for every column seen
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) {
        const uint32_t t = planes[j][k] & carry;
        planes[j][k] ^= carry;
        carry = t;
      }
    }
  }

  // A row with every cell filled.
  __device__ __forceinline__ void add_full_row() {
    uint32_t m[NWF];
#pragma unroll
    for (int k = 0; k < NWF; ++k) m[k] = full_row_word<FW>(k);
    add_row(m);
  }

  __device__ __forceinline__ int height(int c) const {
    int h = 0;
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) h |= static_cast<int>((planes[j][c / 32] >> (c % 32)) & 1u) << j;
    return h;
  }

  // The vector under `flags`: heights, max height, holes, bumpiness.
  template <typename T>
  __device__ __forceinline__ void write(int flags, T* out) const {
    int max_h = 0, sum_h = 0, bump = 0, prev = 0;
#pragma unroll
    for (int c = 0; c < FW; ++c) {
      const int h = height(c);
      if (flags & kHeight) out[c] = static_cast<T>(h);
      max_h = max(max_h, h);
      sum_h += h;
      if (c) bump += abs(h - prev);
      prev = h;
    }
    int k = (flags & kHeight) ? FW : 0;
    if (flags & kMaxHeight) out[k++] = static_cast<T>(max_h);
    if (flags & kHoles) out[k++] = static_cast<T>(sum_h - occupied);
    if (flags & kBumpiness) out[k++] = static_cast<T>(bump);
  }
};

}  // namespace features
