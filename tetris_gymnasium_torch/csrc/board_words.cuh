// Whole-word helpers of the two observation kernels, observe_dict
// (observe_dict.cu) and flagship_observe_board (flagship_step.cu): a padded
// id board int8[H, PW] read and written in words of up to 16 bytes, each
// word's cells found as bits (bit t: cell i0 + t of the word at cell i0),
// and four cells at a time handled as the bytes of a 32-bit lane of the
// word (__vcmpgts4, __vadd4, __vsub4); and the piece tables held across a
// warp (LaneTable).  Both kernels' envs a block follow the card's SM count
// (sm_count.cuh).
//
// The geometry is engine_common.cuh's (the TETRIS_* defines).  A row of the
// board is PW bytes, so a word may straddle rows; a piece's or a box's
// columns never leave their row (the window is clamped into the board, the
// box is cut to it), so a row's bits shifted to the word's cell offset land
// only on that row's cells.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"
#include "sm_count.cuh"

namespace engine {

// The widest word of at most 16 bytes that n bytes are a whole number of.
__host__ __device__ constexpr int word_bytes(int n) {
  return n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// W bytes as 32-bit lanes (one, holding W bytes, where W < 4).
template <int W>
struct Word {
  static constexpr int N = W >= 4 ? W / 4 : 1;
  uint32_t v[N];
};

template <int W>
__device__ __forceinline__ Word<W> load_word(const void* p) {
  Word<W> w;
  if constexpr (W == 16) {
    const uint4 u = __ldg(static_cast<const uint4*>(p));
    w.v[0] = u.x, w.v[1] = u.y, w.v[2] = u.z, w.v[3] = u.w;
  } else if constexpr (W == 8) {
    const uint2 u = __ldg(static_cast<const uint2*>(p));
    w.v[0] = u.x, w.v[1] = u.y;
  } else if constexpr (W == 4) {
    w.v[0] = __ldg(static_cast<const uint32_t*>(p));
  } else if constexpr (W == 2) {
    w.v[0] = __ldg(static_cast<const uint16_t*>(p));
  } else {
    w.v[0] = __ldg(static_cast<const uint8_t*>(p));
  }
  return w;
}

template <int W>
__device__ __forceinline__ void store_word(void* p, const Word<W>& w) {
  if constexpr (W == 16) {
    *static_cast<uint4*>(p) = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
  } else if constexpr (W == 8) {
    *static_cast<uint2*>(p) = make_uint2(w.v[0], w.v[1]);
  } else if constexpr (W == 4) {
    *static_cast<uint32_t*>(p) = w.v[0];
  } else if constexpr (W == 2) {
    *static_cast<uint16_t*>(p) = static_cast<uint16_t>(w.v[0]);
  } else {
    *static_cast<uint8_t*>(p) = static_cast<uint8_t>(w.v[0]);
  }
}

// Columns [c0, c0 + 32) of row r as bits of the word at cell i0: `bits` bit
// j (column c0 + j) moved to bit r * PW + c0 + j - i0.  Bits that fall
// outside [0, 32) are dropped; the caller keeps the word's W.
__device__ __forceinline__ uint32_t place(uint32_t bits, int r, int c0, int i0) {
  const int sh = r * PW + c0 - i0;
  return sh >= 0 ? (sh < 32 ? bits << sh : 0u) : (sh > -32 ? bits >> -sh : 0u);
}

// The piece's cells (row i of `word` at columns xc.., rows yc..yc + S - 1)
// among the W cells of the word at cell i0, as bits.
template <int W>
__device__ __forceinline__ uint32_t piece_bits(const PieceWord& word, int xc, int yc, int i0) {
  constexpr int kRows = (W - 1) / PW + 2;  // the rows a span of W cells can touch
  const int r0 = i0 / PW;
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = r0 + k;
    const unsigned i = static_cast<unsigned>(r - yc);
    if (i < static_cast<unsigned>(S)) bits |= place(piece_row(word, static_cast<int>(i)), r, xc, i0);
  }
  return bits & ((1u << W) - 1u);
}

// Cells of rows [y, y + n) whose columns are set in `cols` (bit j: column
// c0 + j) among the W cells of the word at cell i0, as bits.
template <int W>
__device__ __forceinline__ uint32_t rows_bits(uint32_t cols, int c0, int y, int n, int i0) {
  constexpr int kRows = (W - 1) / PW + 2;
  const int r0 = i0 / PW;
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = r0 + k;
    if (static_cast<unsigned>(r - y) < static_cast<unsigned>(n)) bits |= place(cols, r, c0, i0);
  }
  return bits & ((1u << W) - 1u);
}

// A table of N 32-bit entries held across a warp (lane l holds entries l,
// l + 32, ...), loaded with one coalesced read a lane at the kernel's start
// and read by shuffles: a lookup that would wait on a load that waits on
// another (a piece's field, then its table entry) waits on the first alone.
template <int N>
struct LaneTable {
  static constexpr int K = (N + 31) / 32;
  uint32_t v[K];

  __device__ __forceinline__ void load(const void* table, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = lane + 32 * k < N ? __ldg(static_cast<const uint32_t*>(table) + lane + 32 * k) : 0u;
  }

  // Entry i, 0 where i is outside [0, N); every lane of the warp calls it.
  __device__ __forceinline__ uint32_t get(int i) const {
    uint32_t out = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t x = __shfl_sync(0xffffffffu, v[k], i & 31);
      if (i >= 0 && i < N && (i >> 5) == k) out = x;
    }
    return out;
  }
};

// piece_word_2d from a LaneTable of the packed entries: 0 where the piece or
// the rotation is out of range; every lane of the warp calls it.
template <class Table>
__device__ __forceinline__ PieceWord piece_word_lanes(const Table& packed, int piece, int rot) {
  const bool ok = piece >= 0 && piece < NP && rot >= 0 && rot < 4;
  const int idx = ok ? (piece * 4 + rot) * TW : -1;
  PieceWord w;
#pragma unroll
  for (int t = 0; t < TW; ++t) w.w[t] = packed.get(ok ? idx + t : -1);
  return w;
}

// Four bits as the low bits of four bytes: 0b1011 -> 0x01000101.
__device__ __forceinline__ uint32_t expand4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// The 32-bit lane g of a word's bits as bytes of 0 or 1.
__device__ __forceinline__ uint32_t bit_bytes(uint32_t bits, int g) {
  return expand4((bits >> (4 * g)) & 15u);
}

}  // namespace engine
