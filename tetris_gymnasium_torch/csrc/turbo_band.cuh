// Band helpers of the lanes-per-env instantiations of turbo_step.cu and
// flagship_step.cu: a group of L lanes of one warp (L a power of two,
// 2..32) steps one env.  Every lane of the group runs the env's scalar
// logic (piece, x, y, rotation, holder, bag, queue, key) the same way, with
// engine_common.cuh's helpers, so nothing needs broadcasting and the RNG
// stream cannot diverge; only the rows are split.  Lane l holds band l, the R = ceil(H / L) padded rows
// [l * R, l * R + R) (the last bands ragged where L does not divide H), and
// the S - 1 rows below it, which a window starting in its band reaches.
// What the whole group needs is OR-reduced with shuffles inside the group
// (a hit map over the window starts, the mask of full rows); the line
// clear moves rows between bands through the block's shared memory.  Every
// branch around a shuffle or a __syncwarp depends on the group's scalars
// only, so the group's lanes take it together.
//
// engine_common.cuh's whole-board helpers (hit_map, project, clear_lines,
// spawn_overlap, apply_action) are left as they are for the one-lane build
// and the other engines' kernels; these are their band counterparts and
// give the same bits.
#pragma once

#include "engine_common.cuh"

namespace engine {

template <int L>
struct Band {
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0, "a group is 2..32 lanes, a power of two");
  static constexpr int R = (H + L - 1) / L;  // rows a lane holds
  static constexpr int X = S > 1 ? S - 1 : 1;  // rows below the band that a window reaches
  int lane;       // index in the group
  unsigned mask;  // the group's lanes in the warp
  uint32_t rows[R][NW];   // padded rows lane * R + r (0 past H)
  uint32_t below[X][NW];  // rows (lane + 1) * R + k of the pre-step board (0 past H)
  __device__ __forceinline__ int row0() const { return lane * R; }
};

template <int L, typename T>
__device__ __forceinline__ T group_or(T v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v |= __shfl_xor_sync(mask, v, o, L);
  return v;
}

__device__ __forceinline__ int popcount(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popcount(uint64_t v) { return __popcll(v); }

// Band i of a lane's rows and the rows below it, i < R + X (i a constant
// after unrolling; both indices stay in range for the branch not taken).
template <int L>
__device__ __forceinline__ uint32_t band_row(const Band<L>& bd, int i, int j) {
  constexpr int R = Band<L>::R;
  return i < R ? bd.rows[i < R ? i : 0][j] : bd.below[i >= R ? i - R : 0][j];
}

// The rows below the lane's band, from the lanes that hold them: row
// (lane + 1) * R + k is slot k % R of lane lane + 1 + k / R; past the
// group's last lane it lies past H, where no window that is read reaches.
template <int L>
__device__ __forceinline__ void band_load_below(Band<L>& bd) {
  constexpr int R = Band<L>::R;
#pragma unroll
  for (int k = 0; k < Band<L>::X; ++k)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      bd.below[k][j] = __shfl_down_sync(bd.mask, bd.rows[k % R][j], 1 + k / R, L);
}

// The lane's band of rows uint32[H, NW, B] for env b, and the rows below it
// from the lanes that hold them.
template <int L>
__device__ __forceinline__ void load_band(Band<L>& bd, const uint32_t* rows, int b, int B) {
  constexpr int R = Band<L>::R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = bd.row0() + r;
#pragma unroll
    for (int j = 0; j < NW; ++j) bd.rows[r][j] = h < H ? rows[(h * NW + j) * B + b] : 0u;
  }
  band_load_below(bd);
}

template <int L>
__device__ __forceinline__ void store_band(const Band<L>& bd, uint32_t* rows, int b, int B) {
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
    if (h < H)
#pragma unroll
      for (int j = 0; j < NW; ++j) rows[(h * NW + j) * B + b] = bd.rows[r][j];
  }
}

// hit_map over the band's window starts, OR-reduced over the group: bit y
// for each start y in [0, H - S] where the piece at column x overlaps the
// board.  The rows must be the pre-step board that `below` was loaded from.
template <int L>
__device__ __forceinline__ HitMask band_hit_map(const Band<L>& bd, const PieceWord& p, int x) {
  uint32_t sp[S][NW];
  shifted_piece(p, x, sp);
  HitMask hm = 0;
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    uint32_t acc = 0u;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < NW; ++j) acc |= band_row(bd, r + s, j) & sp[s][j];
    const int y = bd.row0() + r;
    if (y <= H - S && acc != 0u) hm |= HitMask{1} << y;
  }
  return group_or<L>(hm, bd.mask);
}

template <int L>
__device__ __forceinline__ void band_project(Band<L>& bd, const PieceWord& p, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  const int yc = clamp_start(y, H - S, H);
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int off = bd.row0() + r - yc;
    if (off >= 0 && off < S) {
      uint32_t sp[NW];
      shift_row(piece_row(p, off), xc, sp);
#pragma unroll
      for (int j = 0; j < NW; ++j) bd.rows[r][j] |= sp[j];
    }
  }
}

// clear_lines over the group: the mask of full playfield rows is OR-reduced;
// every playfield row of the group's board in `scratch` (the group's
// HEIGHT x NW words of shared memory) starts as the empty row, then each
// kept row whose shift, the count of full rows below it, is <= max_clear
// lands at its row plus that shift, and each lane reads its band back.
// Returns the count of full rows; `full_out`, where given, takes their mask.
template <int L>
__device__ __forceinline__ int band_clear_lines(Band<L>& bd, int max_clear,
                                                uint32_t (*scratch)[NW],
                                                FillMask* full_out = nullptr) {
  constexpr int R = Band<L>::R;
  FillMask mine = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = bd.row0() + r;
    if (h < HEIGHT && row_full(bd.rows[r])) mine |= FillMask{1} << h;
  }
  const FillMask full = group_or<L>(mine, bd.mask);
  if (full_out != nullptr) *full_out = full;
  const int n = popcount(full);
  if (n == 0) return 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = bd.row0() + r;
    if (h < HEIGHT)
#pragma unroll
      for (int j = 0; j < NW; ++j) scratch[h][j] = side_word(j);
  }
  __syncwarp(bd.mask);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = bd.row0() + r;
    if (h < HEIGHT && !((full >> h) & 1u)) {
      const int k = popcount(full >> h >> 1);
      if (k <= max_clear)
#pragma unroll
        for (int j = 0; j < NW; ++j) scratch[h + k][j] = bd.rows[r][j];
    }
  }
  __syncwarp(bd.mask);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = bd.row0() + r;
    if (h < HEIGHT)
#pragma unroll
      for (int j = 0; j < NW; ++j) bd.rows[r][j] = scratch[h][j];
  }
  return n;
}

// spawn_overlap over the group: the piece at (x, row 0) against rows 0..S-1.
template <int L>
__device__ __forceinline__ bool band_spawn_overlap(const Band<L>& bd, const PieceWord& p, int x) {
  const int xc = clamp_start(x, PW - S, PW);
  bool over = false;
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
    if (h < S) {
      uint32_t sp[NW];
      shift_row(piece_row(p, h), xc, sp);
#pragma unroll
      for (int j = 0; j < NW; ++j) over |= (bd.rows[r][j] & sp[j]) != 0u;
    }
  }
  return __any_sync(bd.mask, over);
}

// The band's rows of an empty board (init_env's rows).
template <int L>
__device__ __forceinline__ void band_empty(Band<L>& bd) {
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
#pragma unroll
    for (int j = 0; j < NW; ++j) bd.rows[r][j] = h < HEIGHT ? side_word(j) : full_word(j);
  }
}

// apply_action<kOneHot> on the band: the turbo engine's piece lookup
// (piece_word) or, with kOneHot, the flagship engine's (piece_word_2d).
template <int L, bool kOneHot = false>
__device__ __forceinline__ void band_apply_action(Env& e, const Band<L>& bd, int a, bool uniform,
                                                  const uint32_t* packed, const int32_t* box) {
  if (a == kSwap && !e.has_swapped) {
    swap_piece(e, uniform, box);
    return;
  }
  const PieceWord w = word_of<kOneHot>(packed, e.piece, e.rotation);
  const int dx = a == kLeft ? -1 : (a == kRight ? 1 : 0);
  int x = e.x;
  if (dx != 0 && !collision_at(band_hit_map(bd, w, e.x + dx), e.y)) x = e.x + dx;
  int y = e.y;
  if (a == kDown && !collision_at(band_hit_map(bd, w, x), e.y + 1)) y = e.y + 1;
  const int rot_dir = a == kCw ? 1 : (a == kCcw ? -1 : 0);
  if (rot_dir != 0) {
    const int rot_cand = (e.rotation + rot_dir) & 3;
    if (!collision_at(band_hit_map(bd, word_of<kOneHot>(packed, e.piece, rot_cand), x), y))
      e.rotation = rot_cand;
  }
  e.x = x;
  e.y = y;
}

// The observation's rows [h0, h0 + R) of the playfield (observe_board):
// int8 width cells a row into `frame` (the env's height x width bytes),
// stack 1, active piece -1, overlap 0, no piece once the game is over.
template <int R>
__device__ __forceinline__ void write_frame_rows(const uint32_t (&rows)[R][NW], int h0,
                                                 const Env& e, const uint32_t* packed,
                                                 int8_t* frame) {
  const PieceWord p = e.game_over ? no_piece() : piece_word(packed, e.piece, e.rotation);
  const int xc = clamp_start(e.x, PW - S, PW);
  const int yc = clamp_start(e.y, H - S, H);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = h0 + r;
    if (h < HEIGHT) {
      uint32_t act[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) act[j] = 0u;
      const int off = h - yc;
      if (off >= 0 && off < S) shift_row(piece_row(p, off), xc, act);
      int8_t* o = frame + h * WIDTH;
#pragma unroll
      for (int w = 0; w < WIDTH; ++w) {
        const int col = PAD + w, j = col >> 5, bit = col & 31;
        o[w] = static_cast<int8_t>(static_cast<int>((rows[r][j] >> bit) & 1u) -
                                   static_cast<int>((act[j] >> bit) & 1u));
      }
    }
  }
}

}  // namespace engine
