// The feature vector of a cropped playfield for Hopper (sm_90a), a warp an
// env.
//
// Replaces tetris_gymnasium_tpu/ops/observations.py:feature_vector (:57)
// with column_heights (:17), max_height (:29), holes (:40) and bumpiness
// (:34), under any of the 16 sets of FeatureFlags.  The plain PyTorch twin
// is tetris_gymnasium_torch/ops/observations.py:feature_vector_plain; the
// output is bit-equal to it.
//
// On the TPU these are argmax, cumsum and diff reductions over a vmapped
// [H, W] tile.  Here the env's FH x FW crop is read where it lies (the
// wrapper passes the padded board's int8 buffer with its batch and row
// strides, so the crop is never copied), and a warp takes an env, so that a
// small batch is one round trip and a large one streams:
//   - loads: lane r takes crop row r (and r + 32 where FH > 32).  Every load
//     of a lane is issued before any is used.  In the words build
//     (kWords, chosen by the wrapper where every 16-byte word that holds a
//     byte of the crop's rows lies inside the tensor's storage) a lane
//     loads the aligned 16-byte words that hold its row (two at a 10-column
//     crop: at 10x20 the rows start at 2-byte alignment, row stride 18) and
//     crops in registers; in the bytes build it loads the row's FW bytes;
//   - row masks: each lane folds its row into an FW-bit mask of NWF words
//     (bit c % 32 of word c / 32: column c is not 0), four bytes at a time;
//   - columns: a 32 x 32 bit transpose across the warp by shuffles
//     (transpose32) turns the row masks into column masks, so that lane c
//     holds column c + 32 k (bit r: row r filled, rows 32.. in a second
//     word where FH > 32);
//   - features: a column's height is FH less its first filled row (its
//     lowest set bit), its holes the height less its filled cells; the
//     maximum and the sums are warp reductions (__reduce_max_sync,
//     __reduce_add_sync), the bumpiness pairs each height with its right
//     neighbour's by a shuffle;
//   - stores: lane c writes column c's height, so the stores coalesce, and
//     lanes 0-2 the maximum, the holes and the bumpiness at their places
//     under the flags.
// Envs (warps) a block: kWarps, or where B gives the card's SMs fewer than
// kWarps each, ceil(B / SMs), so that B = 1 and the grouped wrapper's 40
// candidates spread over the SMs (feature_vector_shape); at most
// kBlocksPerSM blocks an SM, the warps striding over a larger batch.
//
// The crop's shape is fixed at compile time by TETRIS_HEIGHT and
// TETRIS_WIDTH (kernels.py:feature_defines builds one library per shape;
// without them, the default 20 x 10): rows of up to 128 columns take up to
// four mask words, up to 64 rows two row blocks (kernels.py:
// MAX_FEATURE_HEIGHT, MAX_FEATURE_WIDTH).  The grouped kernels' feature
// modes keep their own accumulator (features.cuh), which this file leaves
// as it is.
//
// Bound on this card: bytes.  An env reads FH * FW bytes and writes 4n
// (200 and <= 52 at 20 x 10, 600 and <= 132 at 20 x 30); at small B the
// launch floor.

#include <algorithm>
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

using namespace features;

constexpr int FH = TETRIS_HEIGHT;  // crop rows
constexpr int FW = TETRIS_WIDTH;   // crop columns
static_assert(FH >= 1 && FH <= 64 && FW >= 1 && FW <= 128, "features.cu: FH <= 64, FW <= 128");
constexpr int NWF = (FW + 31) / 32;       // words of a row mask
constexpr int NRB = (FH + 31) / 32;       // rows a lane (row blocks)
constexpr int NWW = (15 + FW + 15) / 16;  // 16-byte words that hold a row, at any offset
constexpr int NW32 = (NWW + 1) / 2 > NWF + 1 ? (NWW + 1) / 2 : NWF + 1;  // the words' masks as 32-bit words
constexpr int kWarps = 8;                 // envs (warps) a block at most
constexpr unsigned kAll = 0xFFFFFFFFu;

// Bit i: byte i of x is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t t = ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7) & 0x01010101u;
  return (t * 0x01020408u) >> 24;
}

// Bit i: byte i of the 16-byte word is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes16(const uint4& w) {
  return nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 | nonzero_bytes(w.w) << 12;
}

// The row mask of a row whose byte 0 lies at byte `off` of the 16-byte
// words w (bit c % 32 of word c / 32: column c is not 0).
__device__ __forceinline__ void words_mask(const uint4 (&w)[NWW], int off, uint32_t (&m)[NWF]) {
  uint32_t bits[NW32];
#pragma unroll
  for (int i = 0; i < NW32; ++i) {
    bits[i] = 2 * i < NWW ? nonzero_bytes16(w[2 * i < NWW ? 2 * i : 0]) : 0u;
    if (2 * i + 1 < NWW) bits[i] |= nonzero_bytes16(w[2 * i + 1]) << 16;
  }
#pragma unroll
  for (int k = 0; k < NWF; ++k) m[k] = __funnelshift_r(bits[k], bits[k + 1], off) & full_row_word<FW>(k);
}

// Loads the 16-byte words that hold the FW bytes at `row` (all at once,
// none where the row is not `live`), and its offset in the first.
__device__ __forceinline__ void load_words(const int8_t* row, bool live, uint4 (&w)[NWW], int& off) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(row);
  const uint4* a = reinterpret_cast<const uint4*>(p & ~static_cast<uintptr_t>(15));
  off = static_cast<int>(p & 15);
#pragma unroll
  for (int q = 0; q < NWW; ++q) w[q] = live && 16 * q < off + FW ? __ldg(a + q) : make_uint4(0u, 0u, 0u, 0u);
}

// A 32 x 32 bit matrix across the warp, lane i holding row i (bit j:
// element (i, j)), transposed: lane j then holds column j (bit i).  Stage s
// swaps the off-diagonal s x s blocks of each 2s x 2s block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const uint32_t m = s == 16 ? 0x0000FFFFu : s == 8 ? 0x00FF00FFu : s == 4 ? 0x0F0F0F0Fu
                                             : s == 2 ? 0x33333333u : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(kAll, x, s);
    x = (lane & s) ? ((x & ~m) | ((y & ~m) >> s)) : ((x & m) | ((y & m) << s));
  }
  return x;
}

// One env's vector, by its warp: the crop at `env`, the vector to `o`.
template <bool kWords>
__device__ __forceinline__ void feature_vector_env(const int8_t* __restrict__ env, long long row_stride,
                                                   int flags, int32_t* __restrict__ o, int lane) {
  // loads: every word (or byte) of the lane's rows in flight at once
  uint32_t m[NRB][NWF];
  if constexpr (kWords) {
    uint4 w[NRB][NWW];
    int off[NRB];
#pragma unroll
    for (int j = 0; j < NRB; ++j)
      load_words(env + static_cast<long long>(lane + 32 * j) * row_stride, lane + 32 * j < FH, w[j], off[j]);
#pragma unroll
    for (int j = 0; j < NRB; ++j) words_mask(w[j], off[j], m[j]);
  } else {  // a mask word's 32 bytes in flight at a time (the whole row up to 32 columns)
#pragma unroll
    for (int j = 0; j < NRB; ++j) {
      const int r = lane + 32 * j;
      const int8_t* row = env + static_cast<long long>(r) * row_stride;
#pragma unroll
      for (int k = 0; k < NWF; ++k) {
        int8_t v[32];
#pragma unroll
        for (int c = 0; c < 32; ++c)
          v[c] = r < FH && 32 * k + c < FW ? row[32 * k + c] : static_cast<int8_t>(0);
        m[j][k] = 0u;
#pragma unroll
        for (int c = 0; c < 32; ++c) m[j][k] |= (v[c] != 0 ? 1u : 0u) << c;
      }
    }
  }

  // columns: lane c holds column c + 32 k, rows 32 j.. in word j
  uint32_t col[NRB][NWF];
#pragma unroll
  for (int j = 0; j < NRB; ++j) {
#pragma unroll
    for (int k = 0; k < NWF; ++k) col[j][k] = transpose32(m[j][k], lane);
  }

  // heights (FH less the first filled row), holes (height less filled cells)
  int h[NWF];
  int max_h = 0, holes = 0;
#pragma unroll
  for (int k = 0; k < NWF; ++k) {
    const unsigned long long v = NRB == 1 ? col[0][k]
                                          : col[0][k] | static_cast<unsigned long long>(col[NRB - 1][k]) << 32;
    h[k] = v ? FH + 1 - __ffsll(static_cast<long long>(v)) : 0;
    max_h = max(max_h, h[k]);
    holes += h[k] - __popcll(v);
  }
  int bump = 0;
#pragma unroll
  for (int k = 0; k < NWF; ++k) {
    int next = __shfl_down_sync(kAll, h[k], 1);  // column c + 1's, for lanes 0..30
    if constexpr (NWF > 1) {
      const int wrap = __shfl_sync(kAll, k + 1 < NWF ? h[k + 1 < NWF ? k + 1 : k] : 0, 0);
      if (lane == 31) next = wrap;  // column 32 (k + 1) is lane 0's
    }
    if (lane + 32 * k + 1 < FW) bump += abs(h[k] - next);
  }
  // The reductions run whatever the flags: ptxas of CUDA 12.9 predicated a
  // __reduce_*_sync under `if (flags & ...)` on predicate registers that
  // nothing had set, which gave wrong maxima and holes at 12 x 61 and
  // 40 x 33 (words build); unconditional, it compiles right.
  bump = static_cast<int>(__reduce_add_sync(kAll, static_cast<unsigned>(bump)));
  max_h = static_cast<int>(__reduce_max_sync(kAll, static_cast<unsigned>(max_h)));
  holes = static_cast<int>(__reduce_add_sync(kAll, static_cast<unsigned>(holes)));

  // stores: the heights a column a lane, then the scalars at their places
  if (flags & kHeight) {
#pragma unroll
    for (int k = 0; k < NWF; ++k)
      if (lane + 32 * k < FW) o[lane + 32 * k] = h[k];
  }
  const int i_max = (flags & kHeight) ? FW : 0;
  const int i_holes = i_max + ((flags & kMaxHeight) ? 1 : 0);
  const int i_bump = i_holes + ((flags & kHoles) ? 1 : 0);
  if (lane == 0 && (flags & kMaxHeight)) o[i_max] = max_h;
  if (lane == 1 && (flags & kHoles)) o[i_holes] = holes;
  if (lane == 2 && (flags & kBumpiness)) o[i_bump] = bump;
}

// board: int8, element (b, r, c) at b * batch_stride + r * row_stride + c.
// A warp an env, the warps striding over the batch (blocks_for).
template <bool kWords>
__global__ void __launch_bounds__(32 * kWarps) feature_vector_kernel(
    const int8_t* __restrict__ board, long long batch_stride, long long row_stride, int B,
    int flags, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int b = blockIdx.x * warps + (threadIdx.x >> 5); b < B; b += gridDim.x * warps)
    feature_vector_env<kWords>(board + static_cast<long long>(b) * batch_stride, row_stride, flags,
                               out + static_cast<long long>(b) * n_features(FW, flags), lane);
}

// The card's streaming multiprocessors (1 where it cannot be read).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 1;
  }
  return sms;
}

// Envs (warps) a block for a batch of B: kWarps, or where B gives the
// card's SMs fewer than kWarps each, ceil(B / SMs), so that every SM takes
// a block.
int envs_per_block(int B) { return std::min(kWarps, std::max(1, (B + sm_count() - 1) / sm_count())); }

// Blocks a launch: enough for every env, at most kBlocksPerSM an SM; past
// that the warps stride over the batch, so a large batch does not pay for
// launching a block for every kWarps envs.
constexpr int kBlocksPerSM = 8;
int blocks_for(int B) {
  const int envs = envs_per_block(B);
  return std::min((B + envs - 1) / envs, kBlocksPerSM * sm_count());
}

}  // namespace

// board: int8, element (b, r, c) at b * batch_stride + r * row_stride + c,
// an FH x FW crop; words: every 16-byte word that holds a byte of a crop
// row lies inside the tensor's storage; out: int32[B, n_features(FW, flags)].
extern "C" int feature_vector_launch(const void* board, long long batch_stride,
                                     long long row_stride, int B, int flags, int words, void* out,
                                     void* stream) {
  auto kernel = words ? feature_vector_kernel<true> : feature_vector_kernel<false>;
  kernel<<<blocks_for(B), 32 * envs_per_block(B), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), batch_stride, row_stride, B, flags,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape for a batch of B: out = [envs (warps) a block,
// blocks, 16-byte words a row loads at most in the words build, rows a
// lane].
extern "C" int feature_vector_shape(int B, int* out) {
  out[0] = envs_per_block(B);
  out[1] = blocks_for(B);
  out[2] = NWW;
  out[3] = NRB;
  return 0;
}
