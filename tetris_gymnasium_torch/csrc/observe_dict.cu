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
// On the TPU both are one-hot contractions over the batch.  Here
// observe_dict runs a warp an env, with no block-wide barrier, so that a
// small batch spreads over the SMs (envs a block min(kWarps, ceil(B /
// SMs)), envs_per_block) and a large one streams:
//   - each lane loads its words of the env's board first (the widest words
//     that BOARD is a whole number of: 16 bytes at 10x20, 30x20 and 61x12,
//     8 at 28x14; board_words.cuh), lane w + 32 k word w + 32 k;
//   - in the same round each lane loads one field for the env: lane s < QS
//     the queue slot s, the next HS lanes the holder slots (and their
//     rotations), then the active piece (and its rotation), x, y and the
//     holder count; and the warp loads the piece tables (the packed piece
//     words, the ids, the box sides), a lane an entry (LaneTable); each of
//     the first QS + HS + 1 lanes then looks up its piece's entries by
//     shuffles, not by a load that waits on the field's, so the env's piece
//     work is done once, and the warp hands them round by shuffles;
//   - each board lane finds the piece's cells and the box's cells among its
//     word's cells as bits (the clamped window for the piece, the unclamped
//     x and y for the box, board_words.cuh:piece_bits, rows_bits), tests
//     the piece's cells against the board four bytes at a time
//     (__vcmpgts4), and the warp votes on the collision (__any_sync);
//   - each board lane then adds the id under the piece's cells (__vadd4: the
//     int8 sum, wrapping) unless the warp found a collision, and stores its
//     board and mask words (held in registers up to six words a lane, every
//     board of 16-byte words; a board of narrower words, such as the 6x6
//     pieces' 924 bytes at 30x16, is read again after the vote);
//   - lanes 0..S-1 write the queue strip's rows and lanes S..2S-1 the holder
//     strip's, a row a lane in the widest words that a row's S * QS (S * HS)
//     bytes are a whole number of, the slots' columns known at compile time
//     (four columns of a slot at a time where S is a multiple of 4).
// With null board and mask outputs it writes the strips alone.
// compose_rgb runs a lane a run of 16 consecutive pixels of an image, so
// that its writes go out in whole words, with every id load in flight:
//   - a lane finds its image, its run and its env (n / group) once, in 32
//     bits (the run count a compile-time divisor), then loads the run's 16
//     ids at once: board cells, the strips' cells, bedrock (id_image.cuh's
//     sidebar layout; bedrock from a global byte, so that every id is an
//     unconditional load);
//   - the palette comes in the launch's parameters (a __grid_constant__
//     struct), and while the ids are in flight each warp copies it into its
//     own table in shared memory (the NPAL colours, then black for every
//     id past them); a lookup then never waits on a global load, never
//     reads the constant bank at different ids across a warp (which
//     serialises: on an H100 a block's 256-entry copy behind a barrier
//     took 3 us at 4096 images), and no block-wide barrier holds a warp;
//   - it packs the 16 colours three bytes a pixel into 12 words
//     (__byte_perm) and stores the run's 48 bytes as three 16-byte words
//     (at every geometry whose image is a whole number of 16-byte words:
//     10x20, 30x20, 61x12; else the widest word the image's bytes are a
//     whole number of, 8 at 28x14), an image's last run its TAIL pixels;
//   - a batch whose 16-pixel runs would give the SMs fewer than 256 lanes
//     each (N = 1, the grouped rgb mode's 40 and 120 candidates) runs a
//     pixel a lane instead: its time is the launch and one round trip,
//     which a lane's chain of 16 pixels outlasted;
//   - warps a block: 8, fewer only where the runs fill fewer
//     (compose_rgb_shape).
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per geometry;
// compose_rgb's from the shapes of its inputs, kernels.py:compose_defines):
// padded height <= 64, padded width <= 128, piece side <= 8, 1-32 pieces,
// queue <= 16, holder <= 8, a padded board of <= 3072 cells; the
// composite needs H >= 2 S (id_image.cuh).
//
// Bound on this card: bytes.  observe_dict reads the board and ~50 bytes of
// fields an env and writes the board, the mask and the strips: 484 bytes in
// and 944 out at 10x20 (~0.43 ns an env at 3.35 TB/s), ~0.96 KB and 1.9 KB
// at 30x20; at B = 1 the launch floor is the bound.  compose_rgb reads H *
// PW + its share of the strips a board and writes 3 H * IW (2448 at 10x20,
// 3888 at 30x20); at N = 1 and 40 the launch floor is the bound.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "id_image.cuh"
#include "board_words.cuh"

using namespace engine;

// compose_rgb's palette as a launch parameter, colour i as r | g << 8 | b
// << 16 (kernels.py:_compose_palette): the 32 pieces' and empty's and
// bedrock's at most, the entries past NPAL unused; and the division of an
// image's index by `group` as a multiply-high and a shift (shift -1:
// group 1).
constexpr int kMaxPalette = 34;
struct ComposePalette {
  uint32_t rgb[kMaxPalette];
  uint32_t group_magic;
  int group_shift;
};
static_assert(NPAL <= kMaxPalette, "compose_rgb: at most 32 pieces");

namespace {

constexpr int BOARD = H * PW;        // 432 by default
constexpr int QSW = S * QS;          // bytes of a queue strip's row: 16 by default
constexpr int HSW = S * HS;          // bytes of a holder strip's row: 4 by default
constexpr int QSTRIP = S * QSW;      // bytes of a queue strip: 64 by default
constexpr int HSTRIP = S * HSW;      // bytes of a holder strip: 16 by default
constexpr int WB = word_bytes(BOARD);  // bytes of a board word: 16 by default
constexpr int NBW = BOARD / WB;        // words of a board: 27 by default
constexpr int kRounds = (NBW + 31) / 32;  // board words a lane
constexpr bool kHeld = kRounds <= 6;      // they stay in registers (every board of 16-byte words)
constexpr int kWarps = 8;              // envs (warps) a block of observe_dict at most
// the lanes of an env's warp by the field each loads: the queue slots, the
// holder slots, the active piece, x, y, the holder count
constexpr int L_HOLD = QS, L_ACTIVE = QS + HS, L_X = L_ACTIVE + 1, L_Y = L_X + 1, L_COUNT = L_Y + 1;
static_assert(L_COUNT < 32 && 2 * S <= 32, "an env's fields and strip rows fit a warp");

// Word q of W bytes of a row of bytes held as 32-bit lanes.
template <int W, int N>
__device__ __forceinline__ Word<W> word_at(const uint32_t (&bytes)[N], int q) {
  Word<W> w;
  if constexpr (W >= 4) {
#pragma unroll
    for (int g = 0; g < W / 4; ++g) w.v[g] = bytes[q * (W / 4) + g];
  } else {
    w.v[0] = (bytes[q * W / 4] >> (8 * (q * W % 4))) & ((1u << (8 * W)) - 1u);
  }
  return w;
}

// Row i of a strip of NS slots, S columns each: slot s's row bits `rows[s]`
// (bit j: column s * S + j) as its byte `idb[s]`, 0 elsewhere, stored at dst
// in words of the widest size that NS * S bytes are a whole number of.
template <int NS>
__device__ __forceinline__ void strip_row(uint8_t* dst, const uint32_t (&rows)[NS],
                                          const uint32_t (&idb)[NS]) {
  constexpr int ROW = NS * S;
  constexpr int W = word_bytes(ROW);
  uint32_t bytes[(ROW + 3) / 4];
  if constexpr (S % 4 == 0) {  // four columns of a slot a 32-bit lane
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int q = 0; q < S / 4; ++q) bytes[s * (S / 4) + q] = expand4((rows[s] >> (4 * q)) & 15u) * idb[s];
  } else {
#pragma unroll
    for (int g = 0; g < (ROW + 3) / 4; ++g) bytes[g] = 0u;
#pragma unroll
    for (int j = 0; j < ROW; ++j)
      bytes[j / 4] |= (((rows[j / S] >> (j % S)) & 1u) * idb[j / S]) << (8 * (j % 4));
  }
#pragma unroll
  for (int q = 0; q < ROW / W; ++q) store_word<W>(dst + q * W, word_at<W>(bytes, q));
}

__global__ void __launch_bounds__(32 * kWarps) observe_dict_kernel(
    RenderPtrs p, const uint32_t* __restrict__ packed, const int32_t* __restrict__ box,
    const int32_t* __restrict__ ids, uint8_t* __restrict__ board_out, uint8_t* __restrict__ mask_out,
    uint8_t* __restrict__ holder_out, uint8_t* __restrict__ queue_out, int B) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const bool boards = board_out != nullptr;  // else the strips alone (the same for the whole grid)

  // the board's words: nothing they need is loaded yet; held in registers
  // up to kHeld rounds, else read again for the stores
  const int8_t* src = p.board + static_cast<size_t>(b) * BOARD;
  Word<WB> in[kHeld ? kRounds : 1];
  auto board_word = [&](int k) {
    if constexpr (kHeld) return in[k];
    else return load_word<WB>(src + (lane + 32 * k) * WB);
  };
  if constexpr (kHeld) {
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      if (boards && lane + 32 * k < NBW) in[k] = load_word<WB>(src + (lane + 32 * k) * WB);
  }

  // the piece tables across the warp, then one field a lane, then each
  // subject lane's table entries
  LaneTable<NP * 4 * TW> tpacked;
  LaneTable<NP> tids, tbox;
  tpacked.load(packed, lane);
  tids.load(ids, lane);
  tbox.load(box, lane);
  const int32_t* fp = lane < L_HOLD     ? p.queue + b * QS + lane
                      : lane < L_ACTIVE ? p.holder_piece + b * HS + (lane - L_HOLD)
                      : lane == L_ACTIVE ? p.piece + b
                      : lane == L_X     ? p.x + b
                      : lane == L_Y     ? p.y + b
                                        : p.holder_count + b;
  const int f = lane <= L_COUNT ? __ldg(fp) : 0;
  const int rot = lane >= L_HOLD && lane < L_ACTIVE ? __ldg(p.holder_rotation + b * HS + (lane - L_HOLD))
                  : lane == L_ACTIVE               ? __ldg(p.rotation + b)
                                                   : 0;
  const bool subject = lane <= L_ACTIVE;
  const PieceWord word = piece_word_lanes(tpacked, subject ? f : -1, rot);
  const int id = static_cast<int>(tids.get(subject ? f : -1));
  const int side = static_cast<int>(tbox.get(lane == L_ACTIVE ? f : -1));

  // handed round: the active piece's, x, y and the holder count to every lane
  PieceWord aw;
#pragma unroll
  for (int t = 0; t < TW; ++t) aw.w[t] = __shfl_sync(kAll, word.w[t], L_ACTIVE);
  const int pid = __shfl_sync(kAll, id, L_ACTIVE);
  const int bx = __shfl_sync(kAll, side, L_ACTIVE);
  const int x = __shfl_sync(kAll, f, L_X), y = __shfl_sync(kAll, f, L_Y);
  const int count = __shfl_sync(kAll, f, L_COUNT);
  // ... and the slots' piece words and id bytes
  PieceWord qw[QS], hw[HS];
  uint32_t qid[QS], hid[HS];
#pragma unroll
  for (int s = 0; s < QS; ++s) {
#pragma unroll
    for (int t = 0; t < TW; ++t) qw[s].w[t] = __shfl_sync(kAll, word.w[t], s);
    qid[s] = static_cast<uint32_t>(__shfl_sync(kAll, id, s)) & 0xFFu;
  }
#pragma unroll
  for (int s = 0; s < HS; ++s) {
#pragma unroll
    for (int t = 0; t < TW; ++t) hw[s].w[t] = __shfl_sync(kAll, word.w[t], L_HOLD + s);
    hid[s] = static_cast<uint32_t>(__shfl_sync(kAll, id, L_HOLD + s)) & 0xFFu;
  }

  if (boards) {
    const int xc = clamp_start(x, PW - S, PW), yc = clamp_start(y, H - S, H);
    // the box's columns cut to the board (at most S of them), its rows y..y + bx - 1
    const int mlo = max(x, 0), mhi = min(x + bx, PW);
    const uint32_t mcols = mhi > mlo ? (1u << (mhi - mlo)) - 1u : 0u;
    bool hit = false;
    uint32_t pbits[kHeld ? kRounds : 1];  // the piece's cells of each held word
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      if (lane + 32 * k < NBW) {
        const Word<WB> v = board_word(k);
        const uint32_t pb = piece_bits<WB>(aw, xc, yc, (lane + 32 * k) * WB);
        if constexpr (kHeld) pbits[k] = pb;
#pragma unroll
        for (int g = 0; g < Word<WB>::N; ++g) hit |= (__vcmpgts4(v.v[g], 0u) & bit_bytes(pb, g)) != 0u;
      }
    }
    const uint32_t add = __any_sync(kAll, hit) ? 0u : static_cast<uint32_t>(pid) & 0xFFu;
    const size_t base = static_cast<size_t>(b) * BOARD;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int i0 = (lane + 32 * k) * WB;
      if (lane + 32 * k < NBW) {
        const Word<WB> v = board_word(k);
        uint32_t pb;
        if constexpr (kHeld) pb = pbits[k];
        else pb = piece_bits<WB>(aw, xc, yc, i0);
        const uint32_t mb = rows_bits<WB>(mcols, mlo, y, bx, i0);
        Word<WB> o, m;
#pragma unroll
        for (int g = 0; g < Word<WB>::N; ++g) {
          o.v[g] = __vadd4(v.v[g], bit_bytes(pb, g) * add);
          m.v[g] = bit_bytes(mb, g);
        }
        store_word<WB>(board_out + base + i0, o);
        store_word<WB>(mask_out + base + i0, m);
      }
    }
  }

  if (lane < S) {  // the queue strip's row `lane`, every slot at rotation 0
    uint32_t rows[QS];
#pragma unroll
    for (int s = 0; s < QS; ++s) rows[s] = piece_row(qw[s], lane);
    strip_row<QS>(queue_out + static_cast<size_t>(b) * QSTRIP + lane * QSW, rows, qid);
  } else if (lane < 2 * S) {  // the holder strip's row lane - S, bedrock (1) where a slot is empty
    const int i = lane - S;
    uint32_t rows[HS], idb[HS];
#pragma unroll
    for (int s = 0; s < HS; ++s) {
      rows[s] = s < count ? piece_row(hw[s], i) : (1u << S) - 1u;
      idb[s] = s < count ? hid[s] : 1u;
    }
    strip_row<HS>(holder_out + static_cast<size_t>(b) * HSTRIP + i * HSW, rows, idb);
  }
}

// The composite's runs: a lane takes R consecutive pixels of an image in
// row-major order, 3 R bytes of output (Run<16>: 48 bytes, three 16-byte
// stores; Run<1> for a batch too small to fill the card, whose time is the
// launch and one round trip: a sixteenth of the chain a lane); an image's
// last run holds TAIL pixels.  A run's bytes
// go out as SW-byte stores, the widest word that an image's bytes and a
// run's are a whole number of (16 at 10x20, 30x20 and 61x12 for Run<16>).
constexpr int IMG = H * IW;                  // pixels of an image: 816 by default
constexpr int IMG_BYTES = 3 * IMG;
template <int R>
struct Run {
  static constexpr int RUNS = (IMG + R - 1) / R;            // runs of an image: 51 by default
  static constexpr int TAIL = IMG - R * (RUNS - 1);          // pixels of an image's last run
  static constexpr int SW = word_bytes(IMG_BYTES) < word_bytes(3 * R) ? word_bytes(IMG_BYTES)
                                                                      : word_bytes(3 * R);  // store word
  static constexpr int SPAN = (IW + R - 2) / IW + 1;         // image rows a run touches at most
};
constexpr int kComposeWarps = 8;             // warps a block of compose_rgb at most
constexpr int kSmallRunsPerSM = 8 * 32;      // Run<1> while Run<16> gives the SMs fewer lanes each
constexpr int kPal = NPAL + 1;               // a warp's palette table: the colours, then black
constexpr uint32_t kNpal = NPAL;

// The bedrock id, read where a pixel is the sidebar's bedrock (or past an
// image's last pixel), so that every id comes from a load.
__device__ const uint8_t kBedrock = 1;

template <int R>
__global__ void __launch_bounds__(32 * kComposeWarps) compose_rgb_kernel(
    const uint8_t* __restrict__ board, const uint8_t* __restrict__ queue,
    const uint8_t* __restrict__ holder, const __grid_constant__ ComposePalette palette, int runs,
    uint8_t* __restrict__ out) {
  using RN = Run<R>;
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < static_cast<unsigned>(runs);
  const unsigned n = g / RN::RUNS, k = g - n * RN::RUNS;  // the image and its run
  // its env, n / group by the launcher's multiplier (n < 2**31)
  const unsigned m = palette.group_shift < 0 ? n : __umulhi(n, palette.group_magic) >> palette.group_shift;
  const bool last = k + 1 == RN::RUNS;
  const uint8_t* bd = board + static_cast<size_t>(n) * BOARD;
  const uint8_t* qs = queue + static_cast<size_t>(m) * QSTRIP;
  const uint8_t* hs = holder + static_cast<size_t>(m) * HSTRIP;
  // the rows the run touches, each's board row, strip row and strip width
  // (the queue's above, the holder's at the bottom, none between)
  const int p0 = static_cast<int>(k) * R;
  const int r0 = p0 / IW, c0 = p0 - r0 * IW;
  const uint8_t* brow[RN::SPAN];
  const uint8_t* srow[RN::SPAN];
  int swidth[RN::SPAN];
#pragma unroll
  for (int j = 0; j < RN::SPAN; ++j) {
    const int r = r0 + j;
    brow[j] = bd + r * PW;
    srow[j] = (r < S ? qs : hs) + (r < S ? r * QSW : max(r - (H - S), 0) * HSW);
    swidth[j] = r < S ? QSW : (r >= H - S ? HSW : 0);
  }
  // loads: the run's R ids in flight at once, each address a base and an
  // index picked by selects (a branch a pixel held the loads behind the
  // branches) and each load unconditional (one whose register a
  // predicated move may also write waits for it before the next issues)
  uint32_t id[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = c0 + i;  // the column, before the run wraps to the next row
    const uint8_t* br = brow[0];
    const uint8_t* sr = srow[0];
    int width = swidth[0], c = t;
#pragma unroll
    for (int j = 1; j < RN::SPAN; ++j) {
      const bool next = t >= j * IW;
      br = next ? brow[j] : br;
      sr = next ? srow[j] : sr;
      width = next ? swidth[j] : width;
      c = next ? t - j * IW : c;
    }
    const int sc = c - PW;
    const bool on_board = c < PW, on_strip = !on_board && sc < width;
    const bool valid = live && (!last || i < RN::TAIL);
    const uint8_t* base = valid && on_board ? br : valid && on_strip ? sr : &kBedrock;
    const int index = valid && on_board ? c : valid && on_strip ? sc : 0;
    id[i] = __ldg(base + index);
  }
  // meanwhile the warp's own copy of the palette, entry NPAL black for
  // every id past it: no block-wide barrier
  __shared__ uint32_t tables[kComposeWarps][kPal];
  uint32_t* table = tables[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  for (int t = lane; t < kPal; t += 32) table[t] = t < NPAL ? palette.rgb[t] : 0u;
  __syncwarp();
  if (!live) return;
  // colours, packed three bytes a pixel into 3 R / 4 words (one word of
  // three bytes for a 1-pixel run)
  uint32_t w[(3 * R + 3) / 4];
  if constexpr (R == 1) w[0] = table[min(id[0], kNpal)];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const uint32_t a = table[min(id[4 * q], kNpal)], b = table[min(id[4 * q + 1], kNpal)],
                   c2 = table[min(id[4 * q + 2], kNpal)], d = table[min(id[4 * q + 3], kNpal)];
    w[3 * q] = __byte_perm(a, b, 0x4210);
    w[3 * q + 1] = __byte_perm(b, c2, 0x5421);
    w[3 * q + 2] = __byte_perm(c2, d, 0x6542);
  }
  // stores: the run's 3 R bytes (the last run's 3 TAIL) in SW-byte words
  uint8_t* dst = out + static_cast<size_t>(n) * IMG_BYTES + 3 * R * k;
  const int words = last ? 3 * RN::TAIL / RN::SW : 3 * R / RN::SW;
#pragma unroll
  for (int q = 0; q < 3 * R / RN::SW; ++q)
    if (q < words) store_word<RN::SW>(dst + q * RN::SW, word_at<RN::SW>(w, q));
}

// Envs (warps) a block for a batch of B: kWarps, or where B gives the
// card's SMs fewer than kWarps each, ceil(B / SMs), so that every SM takes
// a block.
int envs_per_block(int B) { return std::min(kWarps, std::max(1, (B + sm_count() - 1) / sm_count())); }

// The run length for N images: 16 pixels, or 1 where 16-pixel runs would
// give the card's SMs fewer than kSmallRunsPerSM lanes each.
int compose_run(int N) {
  return static_cast<long long>(N) * Run<16>::RUNS < static_cast<long long>(kSmallRunsPerSM) * sm_count() ? 1 : 16;
}

// Warps a block of compose_rgb for `runs` runs: kComposeWarps, fewer only
// where the runs fill fewer (on an H100, blocks of one warp spread over
// more SMs took 0.06 us longer at N = 1).
int compose_warps(int runs) { return std::min(kComposeWarps, (runs + 31) / 32); }

}  // namespace

// board: int8[B, H, PW] (16-byte aligned); the other fields of RenderPtrs
// int32; packed: uint32[NP * 4 * TW]; box, ids: int32[NP]; board_out,
// mask_out: uint8[B, H, PW], or both null for the strips alone; holder_out:
// uint8[B, S, S * HS]; queue_out: uint8[B, S, S * QS] (each output 16-byte
// aligned).
extern "C" int observe_dict_launch(const RenderPtrs* ptrs, const void* packed, const void* box,
                                   const void* ids, void* board_out, void* mask_out,
                                   void* holder_out, void* queue_out, int B, void* stream) {
  const int envs = envs_per_block(B);
  const int blocks = (B + envs - 1) / envs;
  observe_dict_kernel<<<blocks, 32 * envs, 0, static_cast<cudaStream_t>(stream)>>>(
      *ptrs, static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box),
      static_cast<const int32_t*>(ids), static_cast<uint8_t*>(board_out),
      static_cast<uint8_t*>(mask_out), static_cast<uint8_t*>(holder_out),
      static_cast<uint8_t*>(queue_out), B);
  return static_cast<int>(cudaGetLastError());
}

// The build's shape for a batch of B: out = [envs (warps) a block, bytes
// of a board word, board words a lane].
extern "C" int observe_dict_shape(int B, int* out) {
  out[0] = envs_per_block(B);
  out[1] = WB;
  out[2] = kRounds;
  return 0;
}

// board: uint8[N, H, PW]; queue: uint8[N / group, S, S * QS]; holder:
// uint8[N / group, S, S * HS]; palette: NPAL colours and the group's
// multiplier; out: uint8[N, H, IW, 3], 16-byte aligned; N * IMG < 2**31
// (the wrapper checks); run: 16 or 1 pixels a lane, or 0 (compose_run(N)).
extern "C" int compose_rgb_launch(const void* board, const void* queue, const void* holder,
                                  const ComposePalette* palette, int N, int run, void* out, void* stream) {
  if (run == 0) run = compose_run(N);
  const int runs = N * (run == 16 ? Run<16>::RUNS : Run<1>::RUNS);
  const int threads = 32 * compose_warps(runs);
  auto kernel = run == 16 ? compose_rgb_kernel<16> : compose_rgb_kernel<1>;
  kernel<<<(runs + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(board), static_cast<const uint8_t*>(queue),
      static_cast<const uint8_t*>(holder), *palette, runs, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape for N images: out = [pixels a run, warps a block,
// bytes of a store word, runs an image, pixels of the last run].
extern "C" int compose_rgb_shape(int N, int* out) {
  const int run = out[0] = compose_run(N);
  const int runs = run == 16 ? Run<16>::RUNS : Run<1>::RUNS;
  out[1] = compose_warps(N * runs);
  out[2] = run == 16 ? Run<16>::SW : Run<1>::SW;
  out[3] = runs;
  out[4] = run == 16 ? Run<16>::TAIL : Run<1>::TAIL;
  return 0;
}
