// Column heights for Hopper (sm_90a): one thread per (column, env).
//
// Replaces tetris_gymnasium_tpu/core/turbo.py:heights (:760) with _col_bits
// (:730): from the packed rows uint32[H, NW, B] (NW = 1 up to a padded
// width of 32), the height of each playfield column, height minus the row
// of its topmost occupied cell or 0 for an empty column, as int32[W, B].
// The plain PyTorch twin is tetris_gymnasium_torch/core/turbo.py:
// heights_plain; the output is bit-equal to it.  The geometry is a run-time
// argument, so one build serves every board.
//
// On the TPU every column is a full-lane [H, B] select and a min over the
// rows.  Here a thread takes one column of one env and walks its word of
// each row top down until the first set bit.  The env index runs fastest,
// so a warp's loads are one row word of 32 neighbouring envs (128 bytes)
// and its stores one column of their heights.  No path calls this kernel
// yet; it is the simple version, to be tuned against the traffic of the
// path that first does.
//
// Bound on this card: bytes.  Each playfield row word is read once and
// each height written once: (height * NW + width) * 4 bytes an env, 120 at
// 10x20 and 280 at 30x20 (NW = 2), 0.036 and 0.084 ns an env at 3.35
// TB/s; a stack that reaches every column early reads fewer rows.  The
// columns of one word each load it, from the cache after the first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) heights_kernel(const uint32_t* __restrict__ rows,
                                                           int32_t* __restrict__ out, int B,
                                                           int height, int width, int padding,
                                                           int nw) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(width) * B) return;
  const int c = static_cast<int>(i / B), b = static_cast<int>(i % B);
  const int col = padding + c;
  const long long row_stride = static_cast<long long>(nw) * B;
  const uint32_t* word = rows + static_cast<long long>(col >> 5) * B + b;
  int top = height;
  for (int h = 0; h < height; ++h) {
    if ((__ldg(word + h * row_stride) >> (col & 31)) & 1u) {
      top = h;
      break;
    }
  }
  out[i] = height - top;
}

}  // namespace

// rows: uint32[H, NW, B]; out: int32[width, B].
extern "C" int heights_launch(const void* rows, void* out, int B, int height, int width,
                              int padding, int nw, void* stream) {
  const long long n = static_cast<long long>(width) * B;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  heights_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), B, height, width, padding,
      nw);
  return static_cast<int>(cudaGetLastError());
}
