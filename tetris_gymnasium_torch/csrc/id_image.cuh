// The id image of the flagship engine's observation, as device code shared
// by render_rgb84.cu and observe_dict.cu (observe_dict and compose_rgb):
// the fields it reads (RenderPtrs), a cell of the board with the active
// piece added unless it collides (tetris_gymnasium_tpu/core/engine.py:
// project_active :227; render_rgb84's) and the composite's sidebar layout
// (ops/observations.py:compose_rgb :84).  observe_dict.cu builds the queue
// and holder thumbnails (_strip :202, queue_holder_strips :239) a row at a
// time itself.
//
// The geometry is engine_common.cuh's, fixed at compile time by the
// TETRIS_* defines (kernels.py:engine_defines, one library per geometry):
// any padded board, piece side S and queue and holder sizes within its
// limits (padded height <= 64, padded width <= 128, S <= 8, queue <= 16,
// holder <= 8).  Piece rows come from PieceWord entries of TW words, so the
// 6x6 pieces' rows that straddle two table words read as in the engine
// kernels.  The sidebar is
// S * max(QS, HS) columns wide, the strips' common width, as compose_rgb
// widens them; each strip is widened with bedrock to it.  An image needs
// H >= 2S (the queue strip, the bedrock between, the holder strip): where
// it is lower the JAX composite fails too, and the wrappers refuse it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"

// The fields of a flagship EngineState that the observation depends on.
struct RenderPtrs {
  const int8_t* board;            // [B, H, PW]
  const int32_t* piece;           // [B]
  const int32_t* rotation;        // [B]
  const int32_t* x;               // [B]
  const int32_t* y;               // [B]
  const int32_t* queue;           // [B, QS]
  const int32_t* holder_piece;    // [B, HS]
  const int32_t* holder_rotation; // [B, HS]
  const int32_t* holder_count;    // [B]
};

namespace engine {

constexpr int SIDE = S * (QS > HS ? QS : HS);  // sidebar width: 16 by default
constexpr int IW = PW + SIDE;                   // id image width: 34 by default
constexpr int NPAL = NP + 2;                    // palette entries: empty, bedrock, the pieces

// Cell (r, c) of project_active's board: `pid` (0 where the piece collides)
// added under the piece's cells as an int8 sum, then viewed as uint8.
__device__ __forceinline__ uint8_t active_cell(const int8_t* board, int r, int c, const PieceWord& word,
                                               int xc, int yc, int pid) {
  int v = board[r * PW + c];
  const int i = r - yc, j = c - xc;
  if (i >= 0 && i < S && j >= 0 && j < S && ((piece_row(word, i) >> j) & 1u)) v += pid;
  return static_cast<uint8_t>(static_cast<int8_t>(v));
}

// Cell (r, sc) of the composite's sidebar: the queue strip in rows 0..S-1,
// the holder strip in the bottom S rows, each widened with bedrock to SIDE
// columns, bedrock between.  `queue(i, j)` and `holder(i, j)` read the strips.
template <class Q, class Hd>
__device__ __forceinline__ uint8_t sidebar_cell(int r, int sc, Q queue, Hd holder) {
  if (r < S) return sc < QS * S ? queue(r, sc) : 1;
  if (r >= H - S && sc < HS * S) return holder(r - (H - S), sc);
  return 1;
}

}  // namespace engine
