// Device code shared by the turbo and the flagship engine kernels
// (turbo_step.cu, flagship_step.cu): the geometry, the counter RNG
// (ops/rng.py:48-114), the 7-bag and uniform draws
// (components/tetromino_randomizer.py), the preview queue, the spawn, the
// holder swap and the bit-packed board helpers (core/turbo.py:157-361,
// ops/bitboard.py, ops/bitboard_wide.py).  Each env lives in one thread's
// registers (struct Env); every array index below is a compile-time
// constant after unrolling.
//
// The geometry is fixed at compile time by the TETRIS_* defines that
// kernels.py:engine_defines passes to nvcc for each config (height, width,
// padding, queue and holder sizes, number of pieces, piece box side); a
// build without them gets the default EngineConfig.  From these follow NW,
// the 32-bit words of a packed row (ceil(padded_width / 32)), and TW, the
// words of a packed piece table entry (ceil(S * S / 32)).  What the wide
// geometries change, and where:
//   - rows are rows[H][NW] and the playfield, side and full-row masks are
//     per-word constants (mask_word), so no shift is ever by 32 or more;
//   - a piece row shifted to column x goes into word x / 32 and, unless
//     x % 32 == 0, carries into the next word (shifted_piece);
//   - a piece row of a TW-word table entry may straddle two table words
//     (piece_row);
//   - hit maps over the H - S + 1 window starts and the mask of full rows
//     are 32-bit words where they fit and 64-bit past that (HitMask,
//     FillMask), hence padded_height <= 64;
//   - the line clear compacts in place, bottom row first, so that no second
//     copy of the rows is held in registers.
// With NW == TW == 1 (every geometry of padded width <= 32 with the 4x4
// pieces) each helper reduces to the single-word code of the default build.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#ifndef TETRIS_HEIGHT
#define TETRIS_HEIGHT 20
#endif
#ifndef TETRIS_WIDTH
#define TETRIS_WIDTH 10
#endif
#ifndef TETRIS_PAD
#define TETRIS_PAD 4
#endif
#ifndef TETRIS_QS
#define TETRIS_QS 4
#endif
#ifndef TETRIS_HS
#define TETRIS_HS 1
#endif
#ifndef TETRIS_NP
#define TETRIS_NP 7
#endif
#ifndef TETRIS_S
#define TETRIS_S 4
#endif

namespace engine {

constexpr int HEIGHT = TETRIS_HEIGHT;
constexpr int WIDTH = TETRIS_WIDTH;
constexpr int PAD = TETRIS_PAD;
constexpr int H = HEIGHT + PAD;      // padded height (24 rows by default)
constexpr int PW = WIDTH + 2 * PAD;  // padded width (18 columns by default)
constexpr int S = TETRIS_S;          // piece box side
constexpr int NP = TETRIS_NP;        // pieces
constexpr int QS = TETRIS_QS;        // queue size
constexpr int HS = TETRIS_HS;        // holder size
constexpr int NW = (PW + 31) / 32;   // words of a packed row
constexpr int TW = (S * S + 31) / 32;  // words of a packed piece table entry
static_assert(H <= 64 && S <= H && S <= PW, "padded height at most 64, piece box inside the board");
static_assert(S <= 8 && NP >= 1 && QS >= 1 && HS >= 1, "kernels.py:engine_defines limits");

// Hit maps (bit y: window start y, 0 <= y <= H - S) and full-row masks.
using HitMask = std::conditional_t<(H - S + 1 <= 32), uint32_t, uint64_t>;
using FillMask = std::conditional_t<(HEIGHT <= 32), uint32_t, uint64_t>;

// Word j of the row mask of columns [lo, hi).
__host__ __device__ constexpr uint32_t mask_word(int lo, int hi, int j) {
  const int a = (lo > 32 * j ? lo : 32 * j) - 32 * j;            // first bit in word j
  const int b = (hi < 32 * j + 32 ? hi : 32 * j + 32) - 32 * j;  // one past the last
  return a >= b ? 0u : static_cast<uint32_t>(((uint64_t{1} << (b - a)) - 1u) << a);
}
__host__ __device__ constexpr uint32_t play_word(int j) { return mask_word(PAD, PAD + WIDTH, j); }
__host__ __device__ constexpr uint32_t side_word(int j) {
  return mask_word(0, PAD, j) | mask_word(PAD + WIDTH, PW, j);
}
__host__ __device__ constexpr uint32_t full_word(int j) { return mask_word(0, PW, j); }

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0x85EBCA6Bu;
constexpr uint32_t M2 = 0xC2B2AE35u;

enum : int { kLeft = 0, kRight = 1, kDown = 2, kCw = 3, kCcw = 4, kDrop = 5, kSwap = 6 };

using Rows = uint32_t[H][NW];  // occupancy, bit w % 32 of word w / 32 = column w

struct Env {
  uint32_t k0, k1;
  Rows rows;
  int piece, rotation, x, y;
  int bag[NP];
  int bag_index;
  int queue[QS];
  int holder_piece[HS], holder_rotation[HS];
  int holder_count;
  bool has_swapped, game_over;
  float score;
  int lines, steps;
};

// A packed piece table entry: row s of the piece in bits [s*S, (s+1)*S) of
// the words laid end to end.
struct PieceWord {
  uint32_t w[TW];
};

// ---- counter RNG (ops/rng.py) ---------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 13;
  x *= M2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t next_bits(Env& e) {
  const uint32_t c0 = e.k0 + GOLDEN;
  const uint32_t c1 = e.k1 + (c0 < e.k0 ? 1u : 0u);
  e.k0 = c0;
  e.k1 = c1;
  return fmix32(c0 ^ fmix32(c1));
}

__device__ __forceinline__ int randint(Env& e, uint32_t n) {
  return static_cast<int>(((next_bits(e) >> 16) * n) >> 16);
}

// Fisher-Yates in the draw order of ops/rng.py:shuffle, into e.bag.
__device__ __forceinline__ void shuffle_bag(Env& e) {
#pragma unroll
  for (int l = 0; l < NP; ++l) e.bag[l] = l;
#pragma unroll
  for (int i = NP - 1; i > 0; --i) {
    const int j = randint(e, static_cast<uint32_t>(i + 1));
    const int vi = e.bag[i];
    int vj = 0;
#pragma unroll
    for (int l = 0; l < NP; ++l) vj = (l == j) ? e.bag[l] : vj;
#pragma unroll
    for (int l = 0; l < NP; ++l) e.bag[l] = (l == j) ? vi : e.bag[l];
    e.bag[i] = vj;
  }
}

// tetromino_randomizer.py: bag_draw (key advances only on a refill) or
// uniform_draw.
__device__ __forceinline__ int draw(Env& e, bool uniform) {
  if (uniform) return randint(e, NP);
  int idx = e.bag_index;
  if (idx >= NP) {
    shuffle_bag(e);
    idx = 0;
  }
  int piece = 0;
#pragma unroll
  for (int l = 0; l < NP; ++l) piece = (l == idx) ? e.bag[l] : piece;
  e.bag_index = idx + 1;
  return piece;
}

// FIFO pop plus backfill (_queue_draw).
__device__ __forceinline__ int queue_draw(Env& e, bool uniform) {
  const int piece = e.queue[0];
  const int refill = draw(e, uniform);
#pragma unroll
  for (int i = 0; i < QS - 1; ++i) e.queue[i] = e.queue[i + 1];
  e.queue[QS - 1] = refill;
  return piece;
}

// ---- bit helpers -----------------------------------------------------------

__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

__device__ __forceinline__ PieceWord load_piece(const uint32_t* packed, int idx) {
  PieceWord p;
#pragma unroll
  for (int t = 0; t < TW; ++t) p.w[t] = __ldg(packed + idx * TW + t);
  return p;
}

__device__ __forceinline__ PieceWord no_piece() {
  PieceWord p;
#pragma unroll
  for (int t = 0; t < TW; ++t) p.w[t] = 0u;
  return p;
}

// The entry of (piece, rotation); 0 where the flat index piece * 4 + rot is
// outside the table (the turbo engine's lookup).
__device__ __forceinline__ PieceWord piece_word(const uint32_t* packed, int piece, int rot) {
  const int idx = piece * 4 + rot;
  return (idx >= 0 && idx < NP * 4) ? load_piece(packed, idx) : no_piece();
}

// The same entry, 0 where the piece or the rotation is out of range (the
// flagship engine's one-hot fetch, ops/bitboard.py:piece_row_bits).
__device__ __forceinline__ PieceWord piece_word_2d(const uint32_t* packed, int piece, int rot) {
  return (piece >= 0 && piece < NP && rot >= 0 && rot < 4) ? load_piece(packed, piece * 4 + rot)
                                                            : no_piece();
}

// Row s of a one-word entry.
__device__ __forceinline__ uint32_t piece_row(uint32_t word, int s) {
  return (word >> (s * S)) & ((1u << S) - 1u);
}

// Row s of an entry (turbo.py:_unpack_rows); s may be a run-time value.
__device__ __forceinline__ uint32_t piece_row(const PieceWord& p, int s) {
  if constexpr (TW == 1) {
    return piece_row(p.w[0], s);
  } else {
    uint32_t v = 0u;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int w0 = i * S / 32, r = i * S % 32;
      uint32_t row = p.w[w0] >> r;
      if (r != 0 && r + S > 32) row |= p.w[w0 + 1] << (32 - r);
      v = i == s ? row & ((1u << S) - 1u) : v;
    }
    return v;
  }
}

// A per-piece int32 table entry (box sides, cell ids); 0 outside the table.
__device__ __forceinline__ int piece_entry(const int32_t* table, int piece) {
  return (piece >= 0 && piece < NP) ? __ldg(table + piece) : 0;
}

__device__ __forceinline__ int spawn_x(const int32_t* box, int piece) {
  return PW / 2 - piece_entry(box, piece) / 2;
}

// A piece row shifted to start at column xc, as the words of a board row
// (turbo.py:_shift): the low word at xc / 32, the carry at the next word.
__device__ __forceinline__ void shift_row(uint32_t row, int xc, uint32_t (&out)[NW]) {
  if constexpr (NW == 1) {
    out[0] = row << xc;
  } else {
    const int word = xc >> 5, off = xc & 31;
    const uint32_t lo = row << off, hi = off ? row >> (32 - off) : 0u;
#pragma unroll
    for (int j = 0; j < NW; ++j) out[j] = j == word ? lo : (j == word + 1 ? hi : 0u);
  }
}

__device__ __forceinline__ void shifted_piece(const PieceWord& p, int x, uint32_t (&sp)[S][NW]) {
  const int xc = clamp_start(x, PW - S, PW);
#pragma unroll
  for (int s = 0; s < S; ++s) shift_row(piece_row(p, s), xc, sp[s]);
}

// The absolute-column piece rows' overlap with the board at every window
// start y in [0, H-S], bit y of the result (the hit map restricted to the
// starts that are read, its word axis OR-reduced: _hit_map_r).
__device__ __forceinline__ HitMask hit_map(const Rows& rows, const PieceWord& p, int x) {
  uint32_t sp[S][NW];
  shifted_piece(p, x, sp);
  HitMask hm = 0;
#pragma unroll
  for (int y = 0; y <= H - S; ++y) {
    uint32_t acc = 0u;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < NW; ++j) acc |= rows[y + s][j] & sp[s][j];
    hm |= static_cast<HitMask>(acc != 0u ? 1u : 0u) << y;
  }
  return hm;
}

__device__ __forceinline__ bool collision_at(HitMask hm, int y) {
  return (hm >> clamp_start(y, H - S, H)) & 1u;
}

// drop_from_map: first hit at or below y+1; first_hit == 0 gives 0.
__device__ __forceinline__ int drop_from_map(HitMask hm, int y) {
  const int z = min(max(y + 1, 0), H - S);
  const HitMask eligible = hm & (~HitMask{0} << z);
  int first_hit = 2 * H;
  if (eligible) {
    if constexpr (sizeof(HitMask) == 4) first_hit = __ffs(eligible) - 1;
    else first_hit = __ffsll(static_cast<long long>(eligible)) - 1;
  }
  const int dist = min(max(first_hit - (y + 1), 0), H);
  return first_hit == 0 ? 0 : dist;
}

__device__ __forceinline__ void project(Rows& rows, const PieceWord& p, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  const int yc = clamp_start(y, H - S, H);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int off = h - yc;
    if (off >= 0 && off < S) {
      uint32_t sp[NW];
      shift_row(piece_row(p, off), xc, sp);
#pragma unroll
      for (int j = 0; j < NW; ++j) rows[h][j] |= sp[j];
    }
  }
}

// A playfield row whose every cell is occupied (the per-word masks).
__device__ __forceinline__ bool row_full(const uint32_t (&row)[NW]) {
  bool full = true;
#pragma unroll
  for (int j = 0; j < NW; ++j) full &= (row[j] & play_word(j)) == play_word(j);
  return full;
}

// Bit h set for each playfield row h that is full.
__device__ __forceinline__ FillMask filled_mask(const Rows& rows) {
  FillMask m = 0;
#pragma unroll
  for (int h = 0; h < HEIGHT; ++h) m |= static_cast<FillMask>(row_full(rows[h]) ? 1u : 0u) << h;
  return m;
}

// Full rows of a FillMask (the grouped kernels' candidate boards), those at
// or above row s (s < HEIGHT), and the kept row of rank k: the least fixed
// point of s = k + full_upto(s), the row a cleared board's row n + k comes
// from after n rows clear.
__device__ __forceinline__ int popc_fill(FillMask m) {
  if constexpr (sizeof(FillMask) == 4) return __popc(m);
  else return __popcll(static_cast<unsigned long long>(m));
}

__device__ __forceinline__ int full_upto(FillMask filled, int s) {
  return popc_fill(filled & ((FillMask{2} << s) - 1u));
}

__device__ __forceinline__ int kept_row(FillMask filled, int k) {
  int s = k;
  for (;;) {
    const int t = k + full_upto(filled, s);
    if (t == s) return s;
    s = t;
  }
}

// Line clear: full playfield rows go; a kept row moves down by the number
// of full rows below it, if that shift is <= max_clear (HEIGHT: no limit).
// Each row d takes the row d - k that moves onto it, or the empty row; rows
// go bottom first, so every source row is read before it is overwritten.
// Returns the count.
__device__ __forceinline__ int clear_lines(Rows& rows, int max_clear) {
  bool filled[HEIGHT];
  int sh[HEIGHT];
  int below = 0;
#pragma unroll
  for (int h = HEIGHT - 1; h >= 0; --h) {
    filled[h] = row_full(rows[h]);
    sh[h] = below;
    below += filled[h] ? 1 : 0;
  }
  if (below == 0) return 0;
#pragma unroll
  for (int d = HEIGHT - 1; d >= 0; --d) {
    int src = -1;
#pragma unroll
    for (int k = 0; k <= d; ++k) {
      if (!filled[d - k] && sh[d - k] == k && k <= max_clear) src = d - k;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t v = side_word(j);
#pragma unroll
      for (int k = 0; k <= d; ++k) v = src == d - k ? rows[d - k][j] : v;
      rows[d][j] = v;
    }
  }
  return below;
}

__device__ __forceinline__ bool spawn_overlap(const Rows& rows, const PieceWord& p, int x) {
  uint32_t sp[S][NW];
  shifted_piece(p, x, sp);
  bool over = false;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < NW; ++j) over |= (rows[s][j] & sp[s][j]) != 0u;
  return over;
}

// A fresh episode from the key words (init_state / _init_from_key), all
// but the board: the bag, the active piece, the queue and the zeroed
// counters.
__device__ __forceinline__ void init_pieces(Env& e, uint32_t k0, uint32_t k1, bool uniform,
                                            const int32_t* box) {
  e.k0 = k0;
  e.k1 = k1;
  shuffle_bag(e);
  e.bag_index = 0;
  int active;
  if (!uniform && QS + 1 <= NP) {
    active = e.bag[0];
#pragma unroll
    for (int i = 0; i < QS; ++i) e.queue[i] = e.bag[1 + i];
    e.bag_index = QS + 1;
  } else {
    active = draw(e, uniform);
#pragma unroll
    for (int i = 0; i < QS; ++i) e.queue[i] = draw(e, uniform);
  }
  e.piece = active;
  e.rotation = 0;
  e.x = spawn_x(box, active);
  e.y = 0;
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    e.holder_piece[i] = 0;
    e.holder_rotation[i] = 0;
  }
  e.holder_count = 0;
  e.has_swapped = false;
  e.game_over = false;
  e.score = 0.0f;
  e.lines = 0;
  e.steps = 0;
}

// init_pieces and an empty board's rows.
__device__ __forceinline__ void init_env(Env& e, uint32_t k0, uint32_t k1, bool uniform,
                                         const int32_t* box) {
  init_pieces(e, k0, k1, uniform, box);
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) e.rows[h][j] = h < HEIGHT ? side_word(j) : full_word(j);
}

// _swap from the pre-step state: with the holder full, key, bag and queue
// stay as they are; with room, the new piece is drawn from the queue.
__device__ __forceinline__ void swap_piece(Env& e, bool uniform, const int32_t* box) {
  const bool full = e.holder_count >= HS;
  int new_piece, new_rot;
  if (full) {
    new_piece = e.holder_piece[0];
    new_rot = e.holder_rotation[0];
#pragma unroll
    for (int i = 0; i < HS - 1; ++i) {
      e.holder_piece[i] = e.holder_piece[i + 1];
      e.holder_rotation[i] = e.holder_rotation[i + 1];
    }
    e.holder_piece[HS - 1] = e.piece;
    e.holder_rotation[HS - 1] = e.rotation;
  } else {
    const int idx = min(max(e.holder_count, 0), HS - 1);
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      if (i == idx) {
        e.holder_piece[i] = e.piece;
        e.holder_rotation[i] = e.rotation;
      }
    }
    new_piece = queue_draw(e, uniform);
    new_rot = 0;
  }
  e.piece = new_piece;
  e.rotation = new_rot;
  e.x = spawn_x(box, new_piece);
  e.y = 0;
  e.holder_count = min(e.holder_count + 1, HS);
  e.has_swapped = true;
}

// Phase 1 of a step, the action's direct effect tested against the
// pre-step rows (_apply_action): a swap, or a move, a soft drop and a
// rotation.  kOneHot picks the flagship engine's piece lookup
// (piece_word_2d) over the turbo engine's (piece_word).
template <bool kOneHot>
__device__ __forceinline__ PieceWord word_of(const uint32_t* packed, int piece, int rot) {
  return kOneHot ? piece_word_2d(packed, piece, rot) : piece_word(packed, piece, rot);
}

template <bool kOneHot>
__device__ __forceinline__ void apply_action(Env& e, int a, bool uniform, const uint32_t* packed,
                                             const int32_t* box) {
  if (a == kSwap && !e.has_swapped) {
    swap_piece(e, uniform, box);
    return;
  }
  const PieceWord w = word_of<kOneHot>(packed, e.piece, e.rotation);
  const int dx = a == kLeft ? -1 : (a == kRight ? 1 : 0);
  int x = e.x;
  if (dx != 0 && !collision_at(hit_map(e.rows, w, e.x + dx), e.y)) x = e.x + dx;
  int y = e.y;
  if (a == kDown && !collision_at(hit_map(e.rows, w, x), e.y + 1)) y = e.y + 1;
  const int rot_dir = a == kCw ? 1 : (a == kCcw ? -1 : 0);
  if (rot_dir != 0) {
    const int rot_cand = (e.rotation + rot_dir) & 3;
    if (!collision_at(hit_map(e.rows, word_of<kOneHot>(packed, e.piece, rot_cand), x), y))
      e.rotation = rot_cand;
  }
  e.x = x;
  e.y = y;
}

// Copies nbytes between 16-byte-aligned buffers with the threads of a
// block, 16 bytes a thread and neighbouring threads on neighbouring words,
// then the bytes past the last whole 16-byte word one a thread (a board of
// H * PW bytes need not be a multiple of 16, nor a ragged last block's).
__device__ __forceinline__ void block_copy16(void* dst, const void* src, int nbytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
  for (int i = (nbytes & ~15) + threadIdx.x; i < nbytes; i += blockDim.x)
    static_cast<int8_t*>(dst)[i] = static_cast<const int8_t*>(src)[i];
}

// block_copy16 where both buffers lie on 16-byte boundaries, else 4-byte
// words where both lie on 4-byte boundaries, else bytes: a block of a few
// boards of BOARD bytes starts at a multiple of 16 only where BOARD allows
// (648 bytes at 28x14, 924 for the 6x6 pieces at 30x16).
__device__ __forceinline__ void block_copy(void* dst, const void* src, int nbytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if ((at & 15u) == 0) {
    block_copy16(dst, src, nbytes);
  } else if ((at & 3u) == 0) {
    uint32_t* d = static_cast<uint32_t*>(dst);
    const uint32_t* s = static_cast<const uint32_t*>(src);
    for (int i = threadIdx.x; i < nbytes / 4; i += blockDim.x) d[i] = s[i];
    for (int i = (nbytes & ~3) + threadIdx.x; i < nbytes; i += blockDim.x)
      static_cast<int8_t*>(dst)[i] = static_cast<const int8_t*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += blockDim.x)
      static_cast<int8_t*>(dst)[i] = static_cast<const int8_t*>(src)[i];
  }
}

}  // namespace engine
