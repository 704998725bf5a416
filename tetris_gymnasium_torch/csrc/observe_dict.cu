// The flagship engine's Dict observation and its RGB composite for Hopper
// (sm_90a).
//
// observe_dict replaces tetris_gymnasium_tpu/core/engine.py:observe_dict
// (:257) with project_active (:227), active_mask (:188),
// queue_holder_strips (:239) and _strip (:202): from the engine state it
// writes the four uint8 arrays of the Dict observation (or, with null board
// and mask outputs, the two strips alone: the grouped rgb mode), the board with the
// active piece's id ADDED in its window unless the piece collides there
// [B, H, PW], the piece's whole bounding box as ones [B, H, PW] (its box,
// not its cells, at the unclamped x and y), the holder strip [B, S, S * HS]
// (bedrock while empty) and the queue strip at rotation 0 [B, S, S * QS].
//
// compose_rgb replaces ops/observations.py:compose_rgb (:84), reached
// through core/engine.py:render_rgb (:529) and the grouped engine's rgb mode
// (core/grouped.py:144): board uint8[N, H, PW] and the strips of board n's
// env n / group -> RGB uint8[N, H, PW + S * max(QS, HS), 3], the palette
// read where the id is below NPAL and black elsewhere (JAX's one-hot
// contraction gives black for an id outside the palette, such as the sum of
// an overlap; a gather would read past the table).  render_rgb(state) is
// observe_dict, then compose_rgb.  The plain PyTorch twins are
// core/engine.py:observe_dict_plain and ops/observations.py:compose_rgb_plain;
// the outputs are bit-equal.
//
// On the TPU both are one-hot contractions over the batch.  Here the id
// image is built by the same device code as render_rgb84.cu's
// (id_image.cuh).  observe_dict takes 8 envs a block of 256 threads: it
// stages their boards in shared memory (16-byte loads where the block's
// boards start on a 16-byte boundary, engine_common.cuh:block_copy), one
// thread an env tests the piece's collision, and the block writes the
// outputs of its envs, which are contiguous, neighbouring threads on
// neighbouring bytes.  compose_rgb takes one thread a pixel and writes its
// 3 bytes.
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per geometry;
// compose_rgb's from the shapes of its inputs, kernels.py:compose_defines):
// padded height <= 64, padded width <= 128, piece side <= 8, 1-32 pieces,
// queue <= 16, holder <= 8, a padded board of <= 3072 cells, so that the 8
// staged boards take at most 24 KB of static shared memory; the composite
// needs H >= 2 S (id_image.cuh).
//
// Bound on this card: bytes.  observe_dict reads ~500 bytes an env and
// writes 944 at 10x20 (~1.0 KB and 1.9 KB at 30x20); compose_rgb reads
// H * PW + the strips a board and writes 3 H * IW (2448 at 10x20, 3888 at
// 30x20).

#include <cstdint>
#include <cuda_runtime.h>

#include "id_image.cuh"

using namespace engine;

namespace {

constexpr int BOARD = H * PW;        // 432 by default
constexpr int QSTRIP = S * QS * S;   // bytes of a queue strip: 64 by default
constexpr int HSTRIP = S * HS * S;   // bytes of a holder strip: 16 by default
constexpr int kEnvs = 8;             // envs a block of observe_dict
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) observe_dict_kernel(
    RenderPtrs p, const uint32_t* __restrict__ packed, const int32_t* __restrict__ box,
    const int32_t* __restrict__ ids, uint8_t* __restrict__ board_out, uint8_t* __restrict__ mask_out,
    uint8_t* __restrict__ holder_out, uint8_t* __restrict__ queue_out, int B) {
  __shared__ __align__(16) int8_t sboard[kEnvs * BOARD];
  __shared__ int spid[kEnvs];
  const int b0 = blockIdx.x * kEnvs;
  const int n = min(kEnvs, B - b0);
  if (board_out != nullptr) {  // else the strips alone (the same for the whole grid)
    block_copy(sboard, p.board + static_cast<size_t>(b0) * BOARD, n * BOARD);
    __syncthreads();
    if (threadIdx.x < n) {
      const int b = b0 + threadIdx.x;
      const int piece = p.piece[b];
      const PieceWord word = piece_word_2d(packed, piece, p.rotation[b]);
      const bool hit = active_collides(sboard + threadIdx.x * BOARD, word,
                                       clamp_start(p.x[b], PW - S, PW), clamp_start(p.y[b], H - S, H));
      spid[threadIdx.x] = hit ? 0 : piece_entry(ids, piece);
    }
    __syncthreads();

    const size_t base = static_cast<size_t>(b0) * BOARD;
    for (int i = threadIdx.x; i < n * BOARD; i += blockDim.x) {
      const int e = i / BOARD, cell = i % BOARD;
      const int b = b0 + e;
      const int r = cell / PW, c = cell % PW;
      const int piece = p.piece[b];
      const int x = p.x[b], y = p.y[b];
      const PieceWord word = piece_word_2d(packed, piece, p.rotation[b]);
      board_out[base + i] = active_cell(sboard + e * BOARD, r, c, word, clamp_start(x, PW - S, PW),
                                        clamp_start(y, H - S, H), spid[e]);
      const int bx = piece_entry(box, piece);
      mask_out[base + i] = (r >= y && r < y + bx && c >= x && c < x + bx) ? 1 : 0;
    }
  }
  for (int i = threadIdx.x; i < n * QSTRIP; i += blockDim.x) {
    const int b = b0 + i / QSTRIP, cell = i % QSTRIP;
    queue_out[static_cast<size_t>(b0) * QSTRIP + i] =
        queue_cell(packed, ids, p.queue + b * QS, cell / (QS * S), cell % (QS * S));
  }
  for (int i = threadIdx.x; i < n * HSTRIP; i += blockDim.x) {
    const int b = b0 + i / HSTRIP, cell = i % HSTRIP;
    holder_out[static_cast<size_t>(b0) * HSTRIP + i] =
        holder_cell(packed, ids, p.holder_piece + b * HS, p.holder_rotation + b * HS,
                    p.holder_count[b], cell / (HS * S), cell % (HS * S));
  }
}

__global__ void __launch_bounds__(kThreads) compose_rgb_kernel(
    const uint8_t* __restrict__ board, const uint8_t* __restrict__ queue,
    const uint8_t* __restrict__ holder, const uint8_t* __restrict__ palette, int group,
    long long pixels, uint8_t* __restrict__ out) {
  const long long px = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (px >= pixels) return;
  const long long n = px / (H * IW);
  const int cell = static_cast<int>(px % (H * IW));
  const int r = cell / IW, c = cell % IW;
  const long long m = n / group;
  const int id = c < PW ? board[n * BOARD + r * PW + c]
                        : sidebar_cell(
                              r, c - PW,
                              [&](int i, int j) { return queue[m * QSTRIP + i * QS * S + j]; },
                              [&](int i, int j) { return holder[m * HSTRIP + i * HS * S + j]; });
  uint8_t* o = out + px * 3;
  if (id < NPAL) {
    o[0] = __ldg(palette + 3 * id);
    o[1] = __ldg(palette + 3 * id + 1);
    o[2] = __ldg(palette + 3 * id + 2);
  } else {
    o[0] = o[1] = o[2] = 0;
  }
}

}  // namespace

// board: int8[B, H, PW] (16-byte aligned); the other fields of RenderPtrs
// int32; packed: uint32[NP * 4 * TW]; box, ids: int32[NP]; board_out,
// mask_out: uint8[B, H, PW], or both null for the strips alone; holder_out:
// uint8[B, S, S * HS]; queue_out: uint8[B, S, S * QS].
extern "C" int observe_dict_launch(const RenderPtrs* ptrs, const void* packed, const void* box,
                                   const void* ids, void* board_out, void* mask_out,
                                   void* holder_out, void* queue_out, int B, void* stream) {
  const int blocks = (B + kEnvs - 1) / kEnvs;
  observe_dict_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *ptrs, static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box),
      static_cast<const int32_t*>(ids), static_cast<uint8_t*>(board_out),
      static_cast<uint8_t*>(mask_out), static_cast<uint8_t*>(holder_out),
      static_cast<uint8_t*>(queue_out), B);
  return static_cast<int>(cudaGetLastError());
}

// board: uint8[N, H, PW]; queue: uint8[N / group, S, S * QS]; holder:
// uint8[N / group, S, S * HS]; palette: uint8[NPAL, 3]; out: uint8[N, H, IW, 3].
extern "C" int compose_rgb_launch(const void* board, const void* queue, const void* holder,
                                  const void* palette, int group, long long N, void* out,
                                  void* stream) {
  const long long pixels = N * H * IW;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  compose_rgb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(board), static_cast<const uint8_t*>(queue),
      static_cast<const uint8_t*>(holder), static_cast<const uint8_t*>(palette), group, pixels,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
