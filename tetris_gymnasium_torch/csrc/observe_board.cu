// Board observation for Hopper (sm_90a): a block of 256 threads, one per
// (env, playfield row).
//
// Replaces tetris_gymnasium_tpu/core/turbo.py:observe_board (:738) with
// unpack_playfield (:702): the packed rows uint32[H, NW, B] (NW = 1 up to a
// padded width of 32) and the active piece become the cropped
// int8[B, height, width] board the policy reads (stack 1, active piece -1,
// overlap 0, nothing of the piece once the game is over).  The geometry is
// a run-time argument, so one build serves every board: a row's words are
// read as its columns reach them, and the piece row is cut from its
// NT-word table entry (a 6x6 piece's rows straddle two words) and tested
// per column against x, never shifted by 32 or more.
// The plain PyTorch twin is tetris_gymnasium_torch/core/turbo.py:
// observe_board_plain; the output is bit-equal to it.
//
// A block takes E envs, as many as give its 256 threads one (env, playfield
// row) each (E = 256 / height, 12 at a 20-row board), rounded down to a
// multiple of 16 / gcd(frame, 16) so that every block's frames start on a
// 16-byte boundary; the env index runs fastest, so a warp reads the same row
// word of neighbouring envs.  Each thread writes its row's width cells into
// the block's frames in shared memory; the block then stores its frames,
// contiguous in the output, with 16-byte stores, neighbouring threads on
// neighbouring words.  (The kernel of earlier slices wrote each row straight
// to device memory, width single bytes at a width-byte stride across the
// warp: 23% of its bound at 10x20, 5% at 30x20, 3% at 61x12.)
//
// Rows of one word whose piece entries also take one word (the default
// board) take a single-word instantiation, kOneWord: the piece row is
// shifted to x once and each column is one shift of two words, as in the
// earlier kernel.  The generic column loop, with its word changes and
// per-column compare against x, costs about 0.4 us at B = 512 to 1024,
// where the kernel is all latency, and a third of its time at B = 65536.
//
// Bound on this card: bytes.  Per env it reads height * NW row words and
// the piece fields (4 int32 + 1 bool) and writes height*width int8: at the
// default 10x20 board 80 + 17 bytes in and 200 bytes out, 297 bytes, or
// 0.089 ns per env at 3.35 TB/s; 777 bytes at 30x20.

#include <cstdint>
#include <cuda_runtime.h>

struct ObsGeometry {
  int height;        // playfield rows written
  int width;         // playfield columns written
  int padding;       // bedrock columns left of the playfield
  int rows_h;        // padded height H of the rows array
  int padded_width;  // width + 2 * padding
  int size;          // piece box side S
  int n_entries;     // entries of the packed table (n_pieces * 4)
  int nw;            // words of a packed row
  int nt;            // words of a packed table entry
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

template <bool kOneWord>
__global__ void __launch_bounds__(kThreads) observe_board_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const int32_t* __restrict__ x,
    const int32_t* __restrict__ y, const uint8_t* __restrict__ game_over,
    const uint32_t* __restrict__ packed, int8_t* __restrict__ out, int B, ObsGeometry g, int envs) {
  extern __shared__ __align__(16) int8_t frames[];  // envs * height * width bytes
  const int frame = g.height * g.width;
  const int base = blockIdx.x * envs;
  const int n = min(envs, B - base);
  for (int item = threadIdx.x; item < n * g.height; item += blockDim.x) {
    const int t = item % n, h = item / n;
    const int b = base + t;
    // the piece's row at this board row, in bits 0..size-1, and its column
    uint32_t prow = 0u;
    const int xc = clamp_start(x[b], g.padded_width - g.size, g.padded_width);
    if (!game_over[b]) {
      const int idx = piece[b] * 4 + rotation[b];
      const int off = h - clamp_start(y[b], g.rows_h - g.size, g.rows_h);
      if (idx >= 0 && idx < g.n_entries && off >= 0 && off < g.size) {
        if (kOneWord) {
          prow = (__ldg(packed + idx) >> (off * g.size)) & ((1u << g.size) - 1u);
        } else {
          const uint32_t* entry = packed + static_cast<long long>(idx) * g.nt;
          const int bit = off * g.size, w0 = bit >> 5, r = bit & 31;
          prow = __ldg(entry + w0) >> r;
          if (r != 0 && r + g.size > 32) prow |= __ldg(entry + w0 + 1) << (32 - r);
          prow &= (1u << g.size) - 1u;
        }
      }
    }
    const uint32_t* row = rows + static_cast<long long>(h) * g.nw * B + b;
    int8_t* o = frames + t * frame + h * g.width;
    if (kOneWord) {
      const uint32_t stack = row[0], active = prow << xc;
      for (int w = 0; w < g.width; ++w) {
        const int col = g.padding + w;
        o[w] = static_cast<int8_t>(static_cast<int>((stack >> col) & 1u) -
                                   static_cast<int>((active >> col) & 1u));
      }
      continue;
    }
    int j = g.padding >> 5;
    uint32_t stack = row[static_cast<long long>(j) * B];
    for (int w = 0; w < g.width; ++w) {
      const int col = g.padding + w;
      if ((col >> 5) != j) {
        j = col >> 5;
        stack = row[static_cast<long long>(j) * B];
      }
      const unsigned dc = static_cast<unsigned>(col - xc);
      const int active = dc < static_cast<unsigned>(g.size) ? (prow >> dc) & 1u : 0;
      o[w] = static_cast<int8_t>(static_cast<int>((stack >> (col & 31)) & 1u) - active);
    }
  }
  __syncthreads();
  // n * frame bytes: 16-byte words (a block's frames start 16-byte aligned),
  // then the tail
  int8_t* dst = out + static_cast<long long>(base) * frame;
  const int nbytes = n * frame;
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(frames)[i];
  for (int i = (nbytes & ~15) + threadIdx.x; i < nbytes; i += blockDim.x) dst[i] = frames[i];
}

}  // namespace

// Envs a block: 256 / height, rounded down to a multiple of m = 16 /
// gcd(frame_bytes, 16) and at least m, so that E * frame_bytes is a multiple
// of 16 (the wrapper keeps 16 frames within 227 KB).
static int envs_per_block(int height, int frame_bytes) {
  int g = 16;
  while (frame_bytes % g) g /= 2;
  const int m = 16 / g;
  const int e = (kThreads / height) / m * m;
  return e < m ? m : e;
}

extern "C" int observe_board_launch(const void* rows, const void* piece, const void* rotation,
                                    const void* x, const void* y, const void* game_over,
                                    const void* packed, void* out, int B,
                                    const ObsGeometry* geometry, void* stream) {
  const int frame = geometry->height * geometry->width;
  const int envs = envs_per_block(geometry->height, frame);
  const int smem = envs * frame;
  // one-word rows and table entries take the single-word code
  const auto kernel = geometry->nw == 1 && geometry->nt == 1 ? observe_board_kernel<true>
                                                             : observe_board_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + envs - 1) / envs;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const int32_t*>(x),
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(game_over),
      static_cast<const uint32_t*>(packed), static_cast<int8_t*>(out), B, *geometry, envs);
  return static_cast<int>(cudaGetLastError());
}
