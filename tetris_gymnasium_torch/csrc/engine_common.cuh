// Device code shared by the turbo and the flagship engine kernels
// (turbo_step.cu, flagship_step.cu): the default geometry, the counter RNG
// (ops/rng.py:48-114), the 7-bag and uniform draws
// (components/tetromino_randomizer.py), the preview queue, the spawn, the
// holder swap and the bit-packed board helpers (core/turbo.py:157-298,
// ops/bitboard.py).  Each env lives in one thread's registers (struct Env);
// every array index below is a compile-time constant after unrolling.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace engine {

constexpr int HEIGHT = 20;
constexpr int WIDTH = 10;
constexpr int PAD = 4;
constexpr int H = HEIGHT + PAD;      // padded height: 24 rows
constexpr int PW = WIDTH + 2 * PAD;  // padded width: 18 columns
constexpr int S = 4;                 // piece box side
constexpr int NP = 7;                // pieces
constexpr int QS = 4;                // queue size
constexpr int HS = 1;                // holder size
constexpr uint32_t PLAY_MASK = ((1u << WIDTH) - 1u) << PAD;
constexpr uint32_t SIDE_MASK = ((1u << PAD) - 1u) | (((1u << PAD) - 1u) << (PAD + WIDTH));
constexpr uint32_t FULL_ROW = (1u << PW) - 1u;

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0x85EBCA6Bu;
constexpr uint32_t M2 = 0xC2B2AE35u;

enum : int { kLeft = 0, kRight = 1, kDown = 2, kCw = 3, kCcw = 4, kDrop = 5, kSwap = 6 };

struct Env {
  uint32_t k0, k1;
  uint32_t rows[H];  // occupancy, bit w = column w
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

// Packed S*S-bit word of (piece, rotation); 0 where the flat index
// piece * 4 + rot is outside the table (the turbo engine's lookup).
__device__ __forceinline__ uint32_t piece_word(const uint32_t* packed, int piece, int rot) {
  const int idx = piece * 4 + rot;
  return (idx >= 0 && idx < NP * 4) ? __ldg(packed + idx) : 0u;
}

// The same word, 0 where the piece or the rotation is out of range (the
// flagship engine's one-hot fetch, ops/bitboard.py:piece_row_bits).
__device__ __forceinline__ uint32_t piece_word_2d(const uint32_t* packed, int piece, int rot) {
  return (piece >= 0 && piece < NP && rot >= 0 && rot < 4) ? __ldg(packed + piece * 4 + rot) : 0u;
}

__device__ __forceinline__ uint32_t piece_row(uint32_t word, int s) {
  return (word >> (s * S)) & ((1u << S) - 1u);
}

// A per-piece int32 table entry (box sides, cell ids); 0 outside the table.
__device__ __forceinline__ int piece_entry(const int32_t* table, int piece) {
  return (piece >= 0 && piece < NP) ? __ldg(table + piece) : 0;
}

__device__ __forceinline__ int spawn_x(const int32_t* box, int piece) {
  return PW / 2 - piece_entry(box, piece) / 2;
}

// Overlap flags of the x-shifted piece at every window start y in [0, H-S],
// bit y of the result (the hit map restricted to the starts that are read).
__device__ __forceinline__ uint32_t hit_map(const uint32_t (&rows)[H], uint32_t word, int x) {
  const int xc = clamp_start(x, PW - S, PW);
  const uint32_t sp0 = piece_row(word, 0) << xc;
  const uint32_t sp1 = piece_row(word, 1) << xc;
  const uint32_t sp2 = piece_row(word, 2) << xc;
  const uint32_t sp3 = piece_row(word, 3) << xc;
  uint32_t hm = 0;
#pragma unroll
  for (int y = 0; y <= H - S; ++y) {
    const uint32_t acc =
        (rows[y] & sp0) | (rows[y + 1] & sp1) | (rows[y + 2] & sp2) | (rows[y + 3] & sp3);
    hm |= (acc != 0u ? 1u : 0u) << y;
  }
  return hm;
}

__device__ __forceinline__ bool collision_at(uint32_t hm, int y) {
  return (hm >> clamp_start(y, H - S, H)) & 1u;
}

// drop_from_map: first hit at or below y+1; first_hit == 0 gives 0.
__device__ __forceinline__ int drop_from_map(uint32_t hm, int y) {
  const int z = min(max(y + 1, 0), H - S);
  const uint32_t eligible = hm & (0xFFFFFFFFu << z);
  const int first_hit = eligible ? __ffs(eligible) - 1 : 2 * H;
  const int dist = min(max(first_hit - (y + 1), 0), H);
  return first_hit == 0 ? 0 : dist;
}

__device__ __forceinline__ void project(uint32_t (&rows)[H], uint32_t word, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  const int yc = clamp_start(y, H - S, H);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int off = h - yc;
    if (off >= 0 && off < S) rows[h] |= piece_row(word, off) << xc;
  }
}

// Bit h set for each playfield row h that is full.
__device__ __forceinline__ uint32_t filled_mask(const uint32_t (&rows)[H]) {
  uint32_t m = 0;
#pragma unroll
  for (int h = 0; h < HEIGHT; ++h) m |= ((rows[h] & PLAY_MASK) == PLAY_MASK ? 1u : 0u) << h;
  return m;
}

// Line clear: full playfield rows go; a kept row moves down by the number
// of full rows below it, if that shift is <= max_clear (HEIGHT: no limit).
// Returns the count.
__device__ __forceinline__ int clear_lines(uint32_t (&rows)[H], int max_clear) {
  bool filled[HEIGHT];
  int sh[HEIGHT];
  int below = 0;
#pragma unroll
  for (int h = HEIGHT - 1; h >= 0; --h) {
    filled[h] = (rows[h] & PLAY_MASK) == PLAY_MASK;
    sh[h] = below;
    below += filled[h] ? 1 : 0;
  }
  if (below == 0) return 0;
  uint32_t out[HEIGHT];
#pragma unroll
  for (int d = 0; d < HEIGHT; ++d) {
    out[d] = SIDE_MASK;
#pragma unroll
    for (int k = 0; k <= d; ++k) {
      if (!filled[d - k] && sh[d - k] == k && k <= max_clear) out[d] = rows[d - k];
    }
  }
#pragma unroll
  for (int d = 0; d < HEIGHT; ++d) rows[d] = out[d];
  return below;
}

__device__ __forceinline__ bool spawn_overlap(const uint32_t (&rows)[H], uint32_t word, int x) {
  const int xc = clamp_start(x, PW - S, PW);
  bool over = false;
#pragma unroll
  for (int s = 0; s < S; ++s) over |= (rows[s] & (piece_row(word, s) << xc)) != 0u;
  return over;
}

// A fresh episode from the key words (init_state / _init_from_key): the
// bag, the active piece, the queue and an empty board's rows.
__device__ __forceinline__ void init_env(Env& e, uint32_t k0, uint32_t k1, bool uniform,
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
#pragma unroll
  for (int h = 0; h < H; ++h) e.rows[h] = h < HEIGHT ? SIDE_MASK : FULL_ROW;
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
__device__ __forceinline__ uint32_t word_of(const uint32_t* packed, int piece, int rot) {
  return kOneHot ? piece_word_2d(packed, piece, rot) : piece_word(packed, piece, rot);
}

template <bool kOneHot>
__device__ __forceinline__ void apply_action(Env& e, int a, bool uniform, const uint32_t* packed,
                                             const int32_t* box) {
  if (a == kSwap && !e.has_swapped) {
    swap_piece(e, uniform, box);
    return;
  }
  const uint32_t w = word_of<kOneHot>(packed, e.piece, e.rotation);
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

// Copies nbytes (a multiple of 16) between 16-byte-aligned buffers with the
// threads of a block, 16 bytes a thread and neighbouring threads on
// neighbouring words.
__device__ __forceinline__ void block_copy16(void* dst, const void* src, int nbytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x) d[i] = s[i];
}

}  // namespace engine
