// The feature vector of a cropped playfield for Hopper (sm_90a), one thread
// per env.
//
// Replaces tetris_gymnasium_tpu/ops/observations.py:feature_vector (:57)
// with column_heights (:17), max_height (:29), holes (:40) and bumpiness
// (:34), under any of the 16 sets of FeatureFlags.  The plain PyTorch twin
// is tetris_gymnasium_torch/ops/observations.py:feature_vector_plain; the
// output is bit-equal to it.
//
// On the TPU these are argmax, cumsum and diff reductions over a vmapped
// [H, W] tile.  Here a thread reads its env's 20x10 crop where it lies (the
// wrapper passes the padded board's int8 buffer with its batch and row
// strides, so the crop is never copied), folds each row into a 10-bit mask
// of the cells that are not 0, and feeds the masks top-down to the
// bit-sliced height counters of features.cuh; it writes int32[n] features.
//
// Bound on this card: bytes.  An env reads 200 bytes and writes 4n <= 52;
// the work is ~20 * (10 + 12) integer operations and the heights' 50.

#include <cstdint>
#include <cuda_runtime.h>

#include "features.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) feature_vector_kernel(
    const int8_t* __restrict__ board, long long batch_stride, long long row_stride, int B,
    int flags, int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int8_t* p = board + static_cast<long long>(b) * batch_stride;
  features::Acc acc;
  acc.init();
#pragma unroll 4
  for (int r = 0; r < features::FH; ++r) {
    const int8_t* row = p + r * row_stride;
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < features::FW; ++c) m |= (row[c] != 0 ? 1u : 0u) << c;
    acc.add_row(m);
  }
  acc.write(flags, out + static_cast<long long>(b) * features::n_features(flags));
}

}  // namespace

// board: int8, element (b, r, c) at b * batch_stride + r * row_stride + c, a
// 20x10 crop; out: int32[B, n_features(flags)].
extern "C" int feature_vector_launch(const void* board, long long batch_stride,
                                     long long row_stride, int B, int flags, void* out,
                                     void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  feature_vector_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), batch_stride, row_stride, B, flags,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
