// Board observation for Hopper (sm_90a): one thread per (env, playfield row).
//
// Replaces tetris_gymnasium_tpu/core/turbo.py:observe_board (:738) with
// unpack_playfield (:702): the packed rows uint32[H, B] and the active piece
// become the cropped int8[B, height, width] board the policy reads (stack 1,
// active piece -1, overlap 0, nothing of the piece once the game is over).
// The plain PyTorch twin is tetris_gymnasium_torch/core/turbo.py:
// observe_board_plain; the output is bit-equal to it.
//
// Why one thread per (env, row) and not per env: the output is 2.5x the
// packed rows it comes from, so its stores decide the traffic.  With the row
// index fastest, the 32 threads of a warp write 320 contiguous bytes, where
// one thread per env would write 200-byte records at a 200-byte stride.  At
// the evaluation's B = 512 it also gives 10,240 threads instead of 512, so
// more than a handful of the 132 SMs have work.  The piece fields are read
// by the 20 threads of an env at once (one broadcast each), and each packed
// row is read once.
//
// Bound on this card: bytes.  Per env it reads height row words and the
// piece fields (4 int32 + 1 bool) and writes height*width int8: at the
// default 10x20 board 80 + 17 bytes in and 200 bytes out, 297 bytes, or
// 0.089 ns per env at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

struct ObsGeometry {
  int height;        // playfield rows written
  int width;         // playfield columns written
  int padding;       // bedrock columns left of the playfield
  int rows_h;        // padded height H of the rows array
  int padded_width;  // width + 2 * padding, at most 32
  int size;          // piece box side S
  int n_entries;     // entries of the packed table (n_pieces * 4)
};

namespace {

__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

__global__ void __launch_bounds__(256) observe_board_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const int32_t* __restrict__ x,
    const int32_t* __restrict__ y, const uint8_t* __restrict__ game_over,
    const uint32_t* __restrict__ packed, int8_t* __restrict__ out, int B, ObsGeometry g) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * g.height) return;
  const int b = static_cast<int>(t / g.height);
  const int h = static_cast<int>(t % g.height);

  const uint32_t stack = rows[static_cast<long long>(h) * B + b];
  uint32_t active = 0u;
  if (!game_over[b]) {
    const int idx = piece[b] * 4 + rotation[b];
    const uint32_t word = (idx >= 0 && idx < g.n_entries) ? __ldg(packed + idx) : 0u;
    const int xc = clamp_start(x[b], g.padded_width - g.size, g.padded_width);
    const int off = h - clamp_start(y[b], g.rows_h - g.size, g.rows_h);
    if (off >= 0 && off < g.size)
      active = ((word >> (off * g.size)) & ((1u << g.size) - 1u)) << xc;
  }
  int8_t* o = out + t * g.width;
  for (int w = 0; w < g.width; ++w) {
    const int bit = g.padding + w;
    o[w] = static_cast<int8_t>(static_cast<int>((stack >> bit) & 1u) -
                               static_cast<int>((active >> bit) & 1u));
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int observe_board_launch(const void* rows, const void* piece, const void* rotation,
                                    const void* x, const void* y, const void* game_over,
                                    const void* packed, void* out, int B,
                                    const ObsGeometry* geometry, void* stream) {
  const long long n = static_cast<long long>(B) * geometry->height;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  observe_board_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const int32_t*>(x),
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(game_over),
      static_cast<const uint32_t*>(packed), static_cast<int8_t*>(out), B, *geometry);
  return static_cast<int>(cudaGetLastError());
}
