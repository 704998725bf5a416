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
// [H, W] tile.  Here a thread reads its env's FH x FW crop where it lies
// (the wrapper passes the padded board's int8 buffer with its batch and row
// strides, so the crop is never copied), folds each row into an FW-bit mask
// of the cells that are not 0, and feeds the masks top-down to the
// bit-sliced height counters of features.cuh; it writes int32[n] features.
//
// The crop's shape is fixed at compile time by TETRIS_HEIGHT and
// TETRIS_WIDTH (kernels.py:feature_defines builds one library per shape;
// without them, the default 20 x 10): rows of up to 128 columns take up to
// four words, heights up to 64 up to seven counter planes
// (kernels.py:MAX_FEATURE_HEIGHT, MAX_FEATURE_WIDTH).
//
// Bound on this card: bytes.  An env reads FH * FW bytes and writes 4n
// (200 and <= 52 at 20 x 10, 600 and <= 132 at 20 x 30); the work is
// ~FH * (3 FW + 15) integer operations and the read-out's ~6 FW.

#include <cstdint>
#include <cuda_runtime.h>

#include "features.cuh"

#ifndef TETRIS_HEIGHT
#define TETRIS_HEIGHT 20
#endif
#ifndef TETRIS_WIDTH
#define TETRIS_WIDTH 10
#endif

namespace {

constexpr int FH = TETRIS_HEIGHT;  // crop rows
constexpr int FW = TETRIS_WIDTH;   // crop columns
using Acc = features::Acc<FH, FW>;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) feature_vector_kernel(
    const int8_t* __restrict__ board, long long batch_stride, long long row_stride, int B,
    int flags, int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int8_t* p = board + static_cast<long long>(b) * batch_stride;
  Acc acc;
  acc.init();
#pragma unroll 4
  for (int r = 0; r < FH; ++r) {
    const int8_t* row = p + r * row_stride;
    uint32_t m[Acc::NWF];
#pragma unroll
    for (int k = 0; k < Acc::NWF; ++k) m[k] = 0u;
#pragma unroll
    for (int c = 0; c < FW; ++c) m[c / 32] |= (row[c] != 0 ? 1u : 0u) << (c % 32);
    acc.add_row(m);
  }
  acc.write(flags, out + static_cast<long long>(b) * features::n_features(FW, flags));
}

}  // namespace

// board: int8, element (b, r, c) at b * batch_stride + r * row_stride + c,
// an FH x FW crop; out: int32[B, n_features(FW, flags)].
extern "C" int feature_vector_launch(const void* board, long long batch_stride,
                                     long long row_stride, int B, int flags, void* out,
                                     void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  feature_vector_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), batch_stride, row_stride, B, flags,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
