// The reference CNN workload's frame, state -> 84x84 gray, for Hopper (sm_90a).
//
// Replaces the JAX chain render_rgb (tetris_gymnasium_tpu/core/engine.py
// :529, with observe_dict :257, project_active :227, queue_holder_strips
// :239 and _strip :202), compose_rgb (ops/observations.py:84) and
// preprocess_rgb84 (ops/image.py:197: resize_area_zoom :87, grayscale_u8
// :149).  The plain PyTorch twin is
// tetris_gymnasium_torch/core/engine.py:render_rgb84_plain; the output is
// bit-equal to it.
//
// On the TPU the chain is a palette one-hot contraction and two small
// integer matmuls over the whole batch, with [B, H, IW, 3] and
// [B, 84, 84, 3] int32 temporaries in HBM.  Here one block of 256 threads
// makes one env's frame and nothing but the frame leaves the SM:
//   1. the board (H * PW bytes, 432 at 10x20) comes into shared memory, in
//      16-byte words where it starts on a 16-byte boundary
//      (engine_common.cuh:block_copy);
//   2. the H x IW id image is built in shared memory (id_image.cuh, shared
//      with observe_dict.cu): the board with the active piece's id ADDED in
//      its window unless the piece collides there, the queue's thumbnails
//      at rotation 0 in rows 0..S-1 of the sidebar, bedrock between, the
//      holder's thumbnails (bedrock while empty) in the bottom S rows, each
//      strip widened with bedrock to the sidebar's S * max(QS, HS) columns;
//   3. each output pixel takes its (at most) 2x2 source ids through the
//      palette and cv2's 11-bit INTER_AREA taps, which the host builds from
//      the same numpy code as the plain version (ops/image.py:
//      area_zoom_taps) and the wrapper keeps on the card (read through the
//      read-only cache): an int32 accumulator per channel, (acc + 2^21) >> 22,
//      a clip to [0, 255], then gray (r*W0 + g*W1 + b*W2) >> 22 with 22-bit
//      weights.  Two taps a side suffice because the chain only enlarges:
//      the composite is at most 84 on each side, and the wrapper raises
//      JAX's ValueError (ops/image.py:_area_zoom_matrix) where it is not;
//   4. the 7056-byte frame is staged in shared memory and stored in 16-byte
//      words (441 of them), neighbouring threads on neighbouring words.
// No accumulator leaves int32: 255 * 2049 * 2049 < 2^31.
//
// Bound on this card: operations.  An env moves ~7.5 KB (the board and the
// piece fields in, the frame out; 2.2 ns at 3.35 TB/s), and does ~47
// integer operations per output pixel (4 tap weights, 12 multiply-adds, the
// rounding and clip of 3 channels, the gray), ~332k an env (9.9 ns at
// 33.5e12 a second), whatever the geometry.
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per
// geometry: padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces, queue <= 16, holder <= 8, a padded board of <= 3072 cells)
// and a composite of at most 84 x 84; the output is always 84x84.  The board, the id image and the
// frame take at most 3 + 16 + 7 KB of static shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "id_image.cuh"

using namespace engine;

namespace {

constexpr int OUT = 84;                 // output side
constexpr int BOARD = H * PW;           // 432 by default
constexpr int kThreads = 256;

// Offsets into the int32 table the wrapper builds (kernels.py:_render_table).
constexpr int T_SY = 0;                 // [OUT, 2] source rows of each output row
constexpr int T_CY = T_SY + 2 * OUT;    // [OUT, 2] their 11-bit coefficients
constexpr int T_SX = T_CY + 2 * OUT;    // [OUT, 2] source columns
constexpr int T_CX = T_SX + 2 * OUT;    // [OUT, 2]
constexpr int T_PAL = T_CX + 2 * OUT;   // [NPAL, 3] RGB
constexpr int T_GRAY = T_PAL + 3 * NPAL;  // [3] 22-bit gray weights

__global__ void __launch_bounds__(kThreads) render_rgb84_kernel(
    RenderPtrs p, const uint32_t* __restrict__ packed, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ table, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int8_t board[BOARD];
  __shared__ uint8_t img[H * IW];
  __shared__ __align__(16) uint8_t frame[OUT * OUT];
  __shared__ int hit;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  block_copy(board, p.board + static_cast<size_t>(b) * BOARD, BOARD);
  const int piece = p.piece[b];
  const PieceWord word = piece_word_2d(packed, piece, p.rotation[b]);
  const int xc = clamp_start(p.x[b], PW - S, PW);
  const int yc = clamp_start(p.y[b], H - S, H);
  __syncthreads();

  // project_active: the piece is drawn only where it does not collide
  if (tid == 0) hit = active_collides(board, word, xc, yc) ? 1 : 0;
  __syncthreads();

  const int pid = hit ? 0 : piece_entry(ids, piece);
  const int hcount = p.holder_count[b];
  const int32_t* queue = p.queue + b * QS;
  const int32_t* hp = p.holder_piece + b * HS;
  const int32_t* hr = p.holder_rotation + b * HS;
  for (int cell = tid; cell < H * IW; cell += kThreads) {
    const int r = cell / IW;
    const int c = cell % IW;
    img[cell] = c < PW ? active_cell(board, r, c, word, xc, yc, pid)
                       : sidebar_cell(
                             r, c - PW,
                             [&](int i, int j) { return queue_cell(packed, ids, queue, i, j); },
                             [&](int i, int j) { return holder_cell(packed, ids, hp, hr, hcount, i, j); });
  }
  __syncthreads();

  const int w0 = __ldg(table + T_GRAY), w1 = __ldg(table + T_GRAY + 1),
            w2 = __ldg(table + T_GRAY + 2);
  for (int px = tid; px < OUT * OUT; px += kThreads) {
    const int Y = px / OUT, X = px % OUT;
    int acc_r = 0, acc_g = 0, acc_b = 0;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
      const int sy = __ldg(table + T_SY + 2 * Y + ty);
      const int cy = __ldg(table + T_CY + 2 * Y + ty);
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int sx = __ldg(table + T_SX + 2 * X + tx);
        const int wgt = cy * __ldg(table + T_CX + 2 * X + tx);
        const int id = img[sy * IW + sx];
        if (id < NPAL) {  // an id outside the palette is black
          acc_r += wgt * __ldg(table + T_PAL + 3 * id);
          acc_g += wgt * __ldg(table + T_PAL + 3 * id + 1);
          acc_b += wgt * __ldg(table + T_PAL + 3 * id + 2);
        }
      }
    }
    const int r = min(max((acc_r + (1 << 21)) >> 22, 0), 255);
    const int g = min(max((acc_g + (1 << 21)) >> 22, 0), 255);
    const int bl = min(max((acc_b + (1 << 21)) >> 22, 0), 255);
    frame[px] = static_cast<uint8_t>((r * w0 + g * w1 + bl * w2) >> 22);
  }
  __syncthreads();
  block_copy16(out + static_cast<size_t>(b) * OUT * OUT, frame, OUT * OUT);
}

}  // namespace

extern "C" int render_rgb84_launch(const RenderPtrs* ptrs, const void* packed, const void* ids,
                                   const void* table, void* out, int B, void* stream) {
  render_rgb84_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *ptrs, static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(table), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
