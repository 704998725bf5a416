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
// makes one env's frame and nothing but the frame leaves the SM.  The
// resize is JAX's two passes (resize_area_zoom), each in shared memory:
//   1. the board (H * PW bytes, 432 at 10x20) comes into shared memory, in
//      16-byte words where it starts on a 16-byte boundary
//      (engine_common.cuh:block_copy), beside the palette as three
//      256-entry channel tables (an id outside the palette reads black) and
//      the 84 packed row taps;
//   2. the H x IW id image is built in shared memory (id_image.cuh, shared
//      with observe_dict.cu): the board with the active piece's id ADDED in
//      its window unless the piece collides there (one window cell a
//      thread, reduced by __syncthreads_or), the queue's thumbnails at
//      rotation 0 in rows 0..S-1 of the sidebar, bedrock between, the
//      holder's thumbnails (bedrock while empty) in the bottom S rows, each
//      strip widened with bedrock to the sidebar's S * max(QS, HS) columns;
//   3. the horizontal pass, h = img . Rx^T: thread (X, k) keeps output column
//      X's two 11-bit cv2 INTER_AREA taps in registers and writes
//      h[c][r][X] = sum_tx cx[X][tx] * pal[c][id[r][sx[X][tx]]] for the rows
//      r = k, k + 3, ... of every channel c, int32, into shared memory
//      (24 x 84 x 3 words at 10x20; 12 * H * 84 bytes);
//   4. the vertical pass, acc = Ry . h: a thread walks 7 output rows of 4
//      adjacent columns [4q, 4q + 4) top to bottom.  Its output rows' taps
//      are two adjacent source rows s, s + 1 that never move up, so the
//      thread holds h[.][s][4q..] and h[.][s + 1][4q..] in registers (16-byte
//      reads) and reads a row of h again only when s advances; each output
//      row's packed taps are one broadcast word of shared memory, decoded
//      once for 4 pixels.  Then cv2's rounding (acc + 2^21) >> 22, the clip
//      to [0, 255] (acc >= 0, so its upper half) and the gray (r*W0 + g*W1 +
//      b*W2) >> 22 with 22-bit weights, 4 gray bytes stored as one word;
//   5. the 7056-byte frame is staged in shared memory and stored in 16-byte
//      words (441 of them), neighbouring threads on neighbouring words.
// Integer sums are associative and no partial sum leaves int32 (255 * 2049
// * 2049 + 2^21 < 2^31), so the two passes give the bits of the 2-D sum.
// A missing second tap has coefficient 0; its product is 0 whatever it
// reads, so it is multiplied, not branched around.
//
// Bound on this card: operations.  An env moves ~7.5 KB (the board and the
// piece fields in, the frame out; 2.2 ns at 3.35 TB/s).  The function needs,
// per output pixel, 6 multiply-adds of the vertical pass, the rounding and
// clip of 3 channels (4 each) and the gray (7), and per source row and
// output column 6 multiply-adds of the horizontal pass: 84 * 84 * 25 + H *
// 84 * 6 32-bit operations an env (188,496 at 10x20, 26.7 a pixel; 5.6 ns at
// 33.5e12 a second).
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per
// geometry: padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces, queue <= 16, holder <= 8, a padded board of <= 3072 cells)
// and a composite of at most 84 x 84; the output is always 84x84.  Shared
// memory is dynamic: 36 KB at 10x20, at most 85 KB (H = 64), opted in
// above 48 KB.

#include <cstdint>
#include <cuda_runtime.h>

#include "id_image.cuh"

using namespace engine;

namespace {

constexpr int OUT = 84;                 // output side
constexpr int BOARD = H * PW;           // 432 by default
constexpr int kThreads = 256;
constexpr int kBands = kThreads / OUT;  // horizontal pass: thread groups of 84, a column a thread
constexpr int kQuads = OUT / 4;         // vertical pass: 4 adjacent columns a thread,
constexpr int kGroups = kThreads / kQuads;  // 12 groups of 21 threads,
constexpr int kGroupRows = OUT / kGroups;   // each walking 7 output rows
// The wrapper launches only where the composite is at most 84 a side (H <= 64 always is).
static_assert(OUT % kGroups == 0 && H <= OUT, "the chain only enlarges, to 84 x 84");

// Offsets into the int32 table the wrapper builds (kernels.py:_render_table).
// A packed tap is s | c0 << 8 | c1 << 20: source index s with 11-bit
// coefficient c0, and s + 1 with c1 (0 where the output has one tap).
constexpr int T_ROW = 0;                // [OUT] packed taps of each output row
constexpr int T_COL = T_ROW + OUT;      // [OUT] packed taps of each output column
constexpr int T_PAL = T_COL + OUT;      // [NPAL, 3] RGB
constexpr int T_GRAY = T_PAL + 3 * NPAL;  // [3] 22-bit gray weights

constexpr int kPal = 256;  // a channel table covers every uint8 id

constexpr int align16(int n) { return (n + 15) / 16 * 16; }
// Dynamic shared memory, in bytes: h, the frame, the palette, the row taps,
// the board, the id image.
constexpr int OFF_H = 0;
constexpr int OFF_FRAME = OFF_H + 3 * H * OUT * 4;
constexpr int OFF_PAL = align16(OFF_FRAME + OUT * OUT);
constexpr int OFF_TAPS = OFF_PAL + 3 * kPal * 4;
constexpr int OFF_THUMB = align16(OFF_TAPS + OUT * 4);  // [QS + HS][TW] piece words
constexpr int OFF_THUMB_ID = OFF_THUMB + (QS + HS) * TW * 4;  // [QS + HS] ids, -1 an empty slot
constexpr int OFF_BOARD = align16(OFF_THUMB_ID + (QS + HS) * 4);
constexpr int OFF_IMG = align16(OFF_BOARD + BOARD);
constexpr int kSmem = align16(OFF_IMG + H * IW);
static_assert(QS + HS <= kThreads, "a thread a thumbnail");
static_assert(kSmem <= 227 * 1024, "shared memory of a block");

__device__ __forceinline__ int tap_src(uint32_t t) { return static_cast<int>(t & 0xFFu); }
__device__ __forceinline__ int tap_c0(uint32_t t) { return static_cast<int>((t >> 8) & 0xFFFu); }
__device__ __forceinline__ int tap_c1(uint32_t t) { return static_cast<int>(t >> 20); }

__global__ void __launch_bounds__(kThreads) render_rgb84_kernel(
    RenderPtrs p, const uint32_t* __restrict__ packed, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ table, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* hbuf = reinterpret_cast<int32_t*>(smem + OFF_H);  // [3][H][OUT]
  uint8_t* frame = smem + OFF_FRAME;                          // [OUT][OUT]
  int32_t* pal = reinterpret_cast<int32_t*>(smem + OFF_PAL);  // [3][kPal]
  uint32_t* row_taps = reinterpret_cast<uint32_t*>(smem + OFF_TAPS);
  uint32_t* thumb_words = reinterpret_cast<uint32_t*>(smem + OFF_THUMB);
  int32_t* thumb_ids = reinterpret_cast<int32_t*>(smem + OFF_THUMB_ID);
  int8_t* board = reinterpret_cast<int8_t*>(smem + OFF_BOARD);
  uint8_t* img = smem + OFF_IMG;  // [H][IW]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  block_copy(board, p.board + static_cast<size_t>(b) * BOARD, BOARD);
  for (int i = tid; i < 3 * kPal; i += kThreads) {
    const int c = i / kPal, id = i % kPal;
    pal[i] = id < NPAL ? __ldg(table + T_PAL + 3 * id + c) : 0;  // an id outside the palette is black
  }
  for (int i = tid; i < OUT; i += kThreads) row_taps[i] = static_cast<uint32_t>(__ldg(table + T_ROW + i));
  // the sidebar's thumbnails (_strip): the queue's pieces at rotation 0, then
  // the holder's at their rotations (-1 for an empty slot, which is bedrock)
  const int hcount = p.holder_count[b];
  if (tid < QS + HS) {
    const int slot = tid - QS;
    const bool queue = tid < QS;
    const int tp = queue ? p.queue[b * QS + tid] : p.holder_piece[b * HS + slot];
    const PieceWord tw = queue ? piece_word_2d(packed, tp, 0)
                               : piece_word_2d(packed, tp, p.holder_rotation[b * HS + slot]);
#pragma unroll
    for (int k = 0; k < TW; ++k) thumb_words[tid * TW + k] = tw.w[k];
    thumb_ids[tid] = queue || slot < hcount ? piece_entry(ids, tp) : -1;
  }
  const int piece = p.piece[b];
  const PieceWord word = piece_word_2d(packed, piece, p.rotation[b]);
  const int xc = clamp_start(p.x[b], PW - S, PW);
  const int yc = clamp_start(p.y[b], H - S, H);
  __syncthreads();

  // project_active: the piece is drawn only where it does not collide
  bool hit_cell = false;
  if (tid < S * S) {
    const int i = tid / S, j = tid % S;
    hit_cell = ((piece_row(word, i) >> j) & 1u) && board[(yc + i) * PW + xc + j] > 0;
  }
  const int pid = __syncthreads_or(hit_cell) ? 0 : piece_entry(ids, piece);
  // a thumbnail cell: the piece's id where its matrix is filled, else 0
  // (id_image.cuh:thumb), from the staged words
  auto thumb_cell = [&](int slot, int i, int j) -> uint8_t {
    PieceWord tw;
#pragma unroll
    for (int k = 0; k < TW; ++k) tw.w[k] = thumb_words[slot * TW + k];
    return ((piece_row(tw, i) >> j) & 1u) ? static_cast<uint8_t>(thumb_ids[slot]) : 0;
  };
  for (int cell = tid; cell < H * IW; cell += kThreads) {
    const int r = cell / IW;
    const int c = cell % IW;
    img[cell] = c < PW ? active_cell(board, r, c, word, xc, yc, pid)
                       : sidebar_cell(
                             r, c - PW, [&](int i, int j) { return thumb_cell(j / S, i, j % S); },
                             [&](int i, int j) -> uint8_t {
                               return thumb_ids[QS + j / S] < 0 ? 1 : thumb_cell(QS + j / S, i, j % S);
                             });
  }
  __syncthreads();

  const int X = tid % OUT;
  const int band = tid / OUT;
  if (band < kBands) {       // the horizontal pass: column X, rows band, band + kBands, ...
    const uint32_t t = static_cast<uint32_t>(__ldg(table + T_COL + X));
    const int s0 = tap_src(t), c0 = tap_c0(t), c1 = tap_c1(t);
    const int s1 = s0 + (c1 != 0 ? 1 : 0);
    for (int r = band; r < H; r += kBands) {
      const int i0 = img[r * IW + s0], i1 = img[r * IW + s1];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        hbuf[(c * H + r) * OUT + X] = c0 * pal[c * kPal + i0] + c1 * pal[c * kPal + i1];
    }
  }
  __syncthreads();

  if (tid < kQuads * kGroups) {  // the vertical pass: 4 columns, kGroupRows rows a thread
    const int X0 = 4 * (tid % kQuads);
    const int y0 = (tid / kQuads) * kGroupRows;
    const int w0 = __ldg(table + T_GRAY), w1 = __ldg(table + T_GRAY + 1),
              w2 = __ldg(table + T_GRAY + 2);
    auto hrow = [&](int c, int r) {  // h[c][r][X0 .. X0 + 3]
      return *reinterpret_cast<const int4*>(hbuf + (c * H + r) * OUT + X0);
    };
    int s = tap_src(row_taps[y0]);
    int4 a[3], nx[3];  // h[.][s][X0..] and h[.][s + 1][X0..] (row H - 1 again past the last)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = hrow(c, s);
      nx[c] = hrow(c, min(s + 1, H - 1));
    }
#pragma unroll
    for (int Y = y0; Y < y0 + kGroupRows; ++Y) {
      const uint32_t t = row_taps[Y];
      const int sy = tap_src(t), c0 = tap_c0(t), c1 = tap_c1(t);
      if (s < sy) {  // the next output row's source row is s or s + 1 (kernels.py:pack_taps)
        s = sy;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a[c] = nx[c];
          nx[c] = hrow(c, min(s + 1, H - 1));
        }
      }
      // acc >= 0 (coefficients and palette are), so the clip to [0, 255]
      // is its upper half
      auto pixel = [&](int ar, int ag, int ab, int br, int bg, int bb) {
        const int r = min((c0 * ar + c1 * br + (1 << 21)) >> 22, 255);
        const int g = min((c0 * ag + c1 * bg + (1 << 21)) >> 22, 255);
        const int bl = min((c0 * ab + c1 * bb + (1 << 21)) >> 22, 255);
        return static_cast<uint32_t>((r * w0 + g * w1 + bl * w2) >> 22);
      };
      const uint32_t p0 = pixel(a[0].x, a[1].x, a[2].x, nx[0].x, nx[1].x, nx[2].x);
      const uint32_t p1 = pixel(a[0].y, a[1].y, a[2].y, nx[0].y, nx[1].y, nx[2].y);
      const uint32_t p2 = pixel(a[0].z, a[1].z, a[2].z, nx[0].z, nx[1].z, nx[2].z);
      const uint32_t p3 = pixel(a[0].w, a[1].w, a[2].w, nx[0].w, nx[1].w, nx[2].w);
      *reinterpret_cast<uint32_t*>(frame + Y * OUT + X0) = p0 | p1 << 8 | p2 << 16 | p3 << 24;
    }
  }
  __syncthreads();
  block_copy16(out + static_cast<size_t>(b) * OUT * OUT, frame, OUT * OUT);
}

}  // namespace

extern "C" int render_rgb84_launch(const RenderPtrs* ptrs, const void* packed, const void* ids,
                                   const void* table, void* out, int B, void* stream) {
  static bool opted = false;
  if (!opted && kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_rgb84_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  opted = true;
  render_rgb84_kernel<<<B, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      *ptrs, static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(table), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
