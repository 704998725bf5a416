// Placement enumeration of the turbo grouped engine for Hopper (sm_90a): an
// env's shared work once, then one thread per (env, candidate).
//
// Replaces tetris_gymnasium_tpu/core/turbo_grouped.py:_candidate_rows (:103,
// the multi-word rows of :126-133 included) with _features_from_rows (:65),
// placements (:152) and placement_boards (:177).  For each of the A =
// WIDTH * 4 (column, rotation) candidates of every env it drops the active
// piece from the top, tests the resting position against the bedrock frame
// (illegal) and the stack (game over), locks it, clears full rows with the
// same max_clear envelope as core/turbo.py:_clear_lines (more than
// max_clear full rows make a game-over placement), and reduces the board to
// the candidate's observation:
//   mode 0, features: float32[B, A, WIDTH + 3] (column heights, max height,
//     holes, bumpiness), written in the layout the network reads, so the
//     JAX transpose at turbo_grouped.py:226 goes away; illegal candidates get
//     the all-ones board's features, game-over candidates zeros;
//   mode 1, boards: float32[B, A, HEIGHT, WIDTH] binary boards, all ones for
//     an illegal candidate and all zeros for a game-over one.
// Both modes write the mask float32[A, B] (1 = legal), game_over bool[A, B]
// and lines int32[A, B], batch-minor as the engine keeps them.  The plain
// PyTorch twins are tetris_gymnasium_torch/core/turbo_grouped.py:
// placements_plain and placement_boards_plain; every output is bit-equal.
//
// On the TPU this is vector code over [H, (NW,) A, B] tiles: every candidate
// board is materialised, stamped, compacted by max_clear + 1 static shifts
// and unpacked.  Here a block takes up to kEnvs envs and stages their
// packed rows, their pieces and the piece tables in shared memory.  What the
// A candidates of an env share is built once, in one pass over the staged
// rows, one job a thread (EnvShared): for each padded column its first
// occupied row at or below each of the first S + 1 rows (walls and floor
// count), each playfield column's filled rows as a mask, the column tops
// with the heights' sum, maximum and bumpiness, the count of filled cells,
// and the full rows.  Each thread then runs its candidate:
//   - the drop from those column tops: a piece cell (s, j) first meets the
//     stack at the start (first occupied row >= z + s of its column) - s,
//     the hit map's least eligible start (drop_from_map with z = 1); only the
//     piece's cells are visited, and the clamp_start of the resting row and
//     the hit map's semantics (a piece in the wall, a collision at row 0) are
//     the turbo engine's;
//   - the S rows under the piece as words: the frame and the stack are the
//     piece rows ANDed with the bedrock and the staged words at the resting
//     row, and the window rows after the lock the staged words ORed with the
//     piece rows; the full rows are the env's outside the window and the
//     patched rows inside it;
//   - features: a candidate that clears nothing changes only the (<= S)
//     columns under its window, where each new height is the larger of the
//     old one and the piece's top cell in that column, so it patches the
//     env's heights, sum, maximum and bumpiness (the S + 1 pairs around the
//     window) and takes holes as the new sum less the filled cells, the
//     piece's among them; a candidate that clears rows (0.06-0.08% of
//     them) is listed, and after the candidates the block takes each listed
//     candidate's columns a thread a column: a column's height comes from
//     its mask (its cells and the piece's, less the full rows), whose top
//     kept cell r falls by the full rows below it, so the height is HEIGHT
//     - r - (n - full rows at or above r), and its holes are that height
//     less its kept cells; so no thread runs a clearing candidate's W
//     columns alone while its block waits.  The block stages its
//     candidates' vectors (an odd stride, so that a warp's threads hit
//     distinct banks) and writes them together;
//   - boards: an output row of a placed candidate is zeros (a cleared row)
//     or the kept staged row of its rank (the (r - n)-th row that is not
//     full), with the piece's cells in its window.  The block builds chunks
//     of its candidates' boards as bytes in shared memory a row (or a
//     32-column piece of a wide row) a thread, then streams each chunk out
//     as one contiguous run, 4 bytes read as a word and written as 4 floats
//     in one 16-byte store, on two buffers where they fit, so that no
//     barrier parts a chunk's stream from the next one's build.  A chunk
//     holds a multiple of 4 candidates, so its run starts on a 16-byte
//     boundary at every geometry, whatever HEIGHT * WIDTH is.  (Float
//     chunks written by one thread's cp.async.bulk stores ran up to 5%
//     faster at 10x20 and 61x12 in one timing and up to 40% slower at 30x20,
//     and at 10x20 in another: PERF.md.)
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines, one library per geometry), as for
// turbo_step.cu: padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces; rows of NW words, piece entries of TW words, full-row masks
// of 64 bits past 32 rows.  With NW == TW == 1 every helper is the
// single-word code.  Envs a block: as many as 256 threads take (6 at 10x20,
// 2 at 30x20, 1 from width 33), or, where a batch gives the card's SMs
// fewer than that each, as many as spread it over every SM (4 at 10x20 and
// B = 512: a block's chain of phases is the time there, and a boards
// block's stream shortens with its envs); the features are staged where
// the block's vectors fit in 160 KB with the rest, else each thread stores
// its own (from width 97 or so; 120x60 in the tests); a
// boards chunk is kChunkBytes of int8 boards (at least 4), on one buffer
// where two do not fit in 227 KB.
//
// Bound on this card: bytes in both modes, 4 HEIGHT WIDTH + 9 a candidate
// for boards (809 at 10x20, 40 candidates an env) and 4 (WIDTH + 3) + 9
// for features (61); the features' operations (the drop, the window and
// the column pass, chip_smoke.py:grouped_placements_ops) take under half
// the time of their bytes.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "engine_common.cuh"
#include "features.cuh"
#include "sm_count.cuh"

using namespace engine;

struct PlacementParams {
  int max_clear;  // compaction envelope
  int mode;       // 0 features, 1 boards
};

namespace {

constexpr int A = WIDTH * 4;                  // candidates an env
constexpr int NWF = features::Acc<HEIGHT, WIDTH>::NWF;  // words of a cropped row
constexpr int kFeat = WIDTH + 3;              // floats of a features vector
constexpr int kFeatStride = kFeat | 1;        // floats between two staged vectors
constexpr int kOccRows = S + 1;               // occupancy tops are read from rows 0..S only
enum : int { kPlaced = 0, kIllegal = 1, kOver = 2 };

// A padded column's rows (bit r: row r).
using ColMask = std::conditional_t<(H <= 32), uint32_t, uint64_t>;
constexpr ColMask kPlayRows = static_cast<ColMask>((uint64_t{1} << HEIGHT) - 1u);  // HEIGHT < H <= 64

// What the A candidates of an env share, built once a block.
struct EnvShared {
  unsigned long long full;              // full playfield rows (bit h: row h), ORed in 32 bits at a time
  int sum, bump, occ, maxh;             // heights' sum, bumpiness, filled cells, max height
  int piece, rotation;
  ColMask col[WIDTH];                   // each playfield column's filled rows
  uint32_t rows[H * NW];                // the staged packed rows
  uint8_t occ_top[kOccRows * PW];       // first occupied row >= r of each padded column (H: none)
  float hf[WIDTH];                      // heights, as the features write them
  uint8_t top[WIDTH];                   // first filled row of each playfield column (HEIGHT: none)
};

// A candidate's placement, as the boards writer and the clearing pass read it.
struct Cand {
  FillMask filled;                      // its full rows
  uint32_t info;                        // status | n << 2 | xc << 9 | yc << 16
  PieceWord word;
};

constexpr int kEnvs = 256 / A > 1 ? 256 / A : 1;  // envs a block
constexpr int kThreads = kEnvs * A;
constexpr int kTable = NP * 4 * TW;   // words of the packed piece table
constexpr int kStatic = kEnvs * static_cast<int>(sizeof(EnvShared)) +
                        kThreads * static_cast<int>(sizeof(Cand) + 9 + 16) + 4 * (kTable + NP + 1);
static_assert(kStatic <= 46 * 1024, "grouped_placements: a block's static shared memory passes 46 KB");
constexpr int kMaxSmem = 227 * 1024;
constexpr bool kStageFeatures = kStatic + kThreads * kFeatStride * 4 <= 160 * 1024;
constexpr int kBoardBytes = HEIGHT * WIDTH;  // an int8 board in a chunk
constexpr int kChunkBytes = 24 * 1024;
// Candidates a boards chunk: at least 4, a multiple of 4, within
// kChunkBytes and a block's candidates, and where one is, a count whose rows
// (32-column pieces of rows) split evenly across the threads.
constexpr int chunk_candidates() {
  int most = (kChunkBytes / kBoardBytes) & ~3;
  if (most < 4) return 4;
  if (most > kThreads) most = kThreads;
  for (int c = most; c >= 4; c -= 4)
    if (c * HEIGHT * NWF % kThreads == 0) return c;
  return most;
}
constexpr int kChunk = chunk_candidates();
constexpr int kBuffers = kStatic + 2 * kChunk * kBoardBytes <= kMaxSmem ? 2 : 1;
static_assert(kThreads % 4 == 0 && kStatic + kBuffers * kChunk * kBoardBytes <= kMaxSmem,
              "grouped_placements: boards chunk");

__device__ __forceinline__ int first_bit(ColMask m) {  // m != 0
  if constexpr (sizeof(ColMask) == 4) return __ffs(m) - 1;
  else return __ffsll(static_cast<long long>(m)) - 1;
}

__device__ __forceinline__ int count_bits(ColMask m) {
  if constexpr (sizeof(ColMask) == 4) return __popc(m);
  else return __popcll(static_cast<unsigned long long>(m));
}

// Column c's height after the candidate's lock and clear, and its kept
// cells: its cells and the piece's less the full rows; the top kept cell r
// falls by the n - full_upto(r) full rows below it.
__device__ __forceinline__ int cleared_height(const EnvShared& es, const Cand& cd, int c, int& cells) {
  const int n = (cd.info >> 2) & 127u, j = c + PAD - static_cast<int>((cd.info >> 9) & 127u);
  const int yc = (cd.info >> 16) & 255u;
  ColMask piece = 0;
  if (j >= 0 && j < S) {
#pragma unroll
    for (int i = 0; i < S; ++i) piece |= static_cast<ColMask>((piece_row(cd.word, i) >> j) & 1u) << (yc + i);
  }
  const ColMask kept = (es.col[c] | piece) & ~static_cast<ColMask>(cd.filled);
  cells = count_bits(kept);
  if (!kept) return 0;
  const int r = first_bit(kept);
  return HEIGHT - r - (n - full_upto(cd.filled, r));
}

// Candidate t's features vector: staged in shared memory, or in obs.
__device__ __forceinline__ float* features_of(int t, float* sfeat, float* obs, long long first) {
  if constexpr (kStageFeatures) return sfeat + t * kFeatStride;
  else return obs + (first + t) * kFeat;
}

// Columns [32 k, min(32 k + 32, WIDTH)) of output row r of a candidate's
// board, as bytes 0 and 1 at dst (the row's first cell).
__device__ __forceinline__ void build_row(uint8_t* dst, const Cand& cd, const EnvShared& es, int r,
                                          int k) {
  const int status = cd.info & 3u;
  uint32_t word = 0u;
  if (status == kIllegal) {
    word = 0xFFFFFFFFu;
  } else if (status == kPlaced) {
    const int n = (cd.info >> 2) & 127u;
    if (r >= n) {
      const int s = n == 0 ? r : kept_row(cd.filled, r - n);
      uint32_t row[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) row[j] = es.rows[s * NW + j];
      const int i = s - static_cast<int>((cd.info >> 16) & 255u);
      if (i >= 0 && i < S) {
        uint32_t pm[NW];
        shift_row(piece_row(cd.word, i), (cd.info >> 9) & 127u, pm);
#pragma unroll
        for (int j = 0; j < NW; ++j) row[j] |= pm[j];
      }
      uint32_t m[NWF];
      features::crop_row<NW, PAD, WIDTH>(row, m);
      word = m[0];
#pragma unroll
      for (int w = 1; w < NWF; ++w) word = k == w ? m[w] : word;
    }
  }
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (32 * k + c < WIDTH) dst[32 * k + c] = static_cast<uint8_t>((word >> c) & 1u);
}

// Two blocks an SM in the launch bounds: with the thread count alone,
// ptxas held some geometries to 40 registers and spilled 4-8 bytes.
__global__ void __launch_bounds__(kThreads, 2) grouped_placements_kernel(
    const uint32_t* __restrict__ rows_in, const int32_t* __restrict__ piece_in,
    const int32_t* __restrict__ rotation_in, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ box, float* __restrict__ obs, float* __restrict__ mask,
    uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out, int B, PlacementParams prm) {
  __shared__ EnvShared senv[kEnvs];
  __shared__ Cand scand[kThreads];
  __shared__ float smask[kThreads];     // the candidates' mask, game_over and lines,
  __shared__ int32_t slines[kThreads];  // written batch-minor by the block together
  __shared__ uint8_t sover[kThreads];
  __shared__ int sclear[kThreads];      // features: the candidates that clear rows,
  __shared__ int stotal[3][kThreads];   // and their maximum, holes and bumpiness
  __shared__ int sclear_n;
  __shared__ uint32_t spacked[kTable];
  __shared__ int sbox[NP];
  extern __shared__ __align__(16) unsigned char sdyn[];  // feature vectors or boards chunks

  const int envs = blockDim.x / A;  // envs a block: kEnvs, or fewer for a small batch
  const int b0 = blockIdx.x * envs;
  const int n_env = min(envs, B - b0);
  const bool feat = prm.mode == 0;
  // the envs' rows ([H][NW][B] in global memory), pieces and the piece tables
  for (int i = threadIdx.x; i < n_env * H * NW; i += blockDim.x) {
    const int hj = i / n_env, e = i % n_env;
    senv[e].rows[hj] = rows_in[static_cast<long long>(hj) * B + b0 + e];
  }
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) spacked[i] = __ldg(packed + i);
  for (int i = threadIdx.x; i < NP; i += blockDim.x) sbox[i] = __ldg(box + i);
  if (threadIdx.x == 0) sclear_n = 0;
  for (int e = threadIdx.x; e < n_env; e += blockDim.x) {
    EnvShared& es = senv[e];
    es.piece = piece_in[b0 + e];
    es.rotation = rotation_in[b0 + e];
    es.full = 0;
    es.sum = es.bump = es.occ = es.maxh = 0;
  }
  __syncthreads();

  // -- an env's shared work, in one pass over its staged rows, one job a
  //    thread: each padded column's occupancy tops (and a playfield
  //    column's mask, top, filled count and bumpiness term with its left
  //    neighbour), each playfield row's fullness; the rows' jobs start on a
  //    warp of their own where that takes no second round
  const int n_cols = n_env * PW;
  const int o_warp = (n_cols + 31) & ~31;
  const int o_rows = o_warp + n_env * HEIGHT <= static_cast<int>(blockDim.x) ? o_warp : n_cols;
  for (int i = threadIdx.x; i < o_rows + n_env * HEIGHT; i += blockDim.x) {
    if (i < o_rows) {
      if (i >= n_cols) continue;
      const int e = i / PW, col = i % PW;
      EnvShared& es = senv[e];
      // the column's occupied rows as a mask (bit r: row r), and its left
      // neighbour's, the loads all in flight; then each top is a find-first
      const uint32_t* here = es.rows + (col >> 5);
      const uint32_t* left = es.rows + ((col - 1) >> 5);  // read only for col > PAD
      const int sh = col & 31, lsh = (col - 1) & 31;
      ColMask cm = 0, lm = 0;
#pragma unroll
      for (int r = 0; r < H; ++r) {
        cm |= static_cast<ColMask>((here[r * NW] >> sh) & 1u) << r;
        if (col > PAD && r < HEIGHT) lm |= static_cast<ColMask>((left[r * NW] >> lsh) & 1u) << r;
      }
#pragma unroll
      for (int r = 0; r < kOccRows; ++r)
        es.occ_top[r * PW + col] = static_cast<uint8_t>((cm >> r) ? r + first_bit(cm >> r) : H);
      if (col >= PAD && col < PAD + WIDTH) {
        const ColMask play = cm & kPlayRows;
        const int top = play ? first_bit(play) : HEIGHT;
        es.col[col - PAD] = play;
        es.top[col - PAD] = static_cast<uint8_t>(top);
        es.hf[col - PAD] = static_cast<float>(HEIGHT - top);
        atomicAdd(&es.sum, HEIGHT - top);
        atomicAdd(&es.occ, count_bits(play));
        atomicMax(&es.maxh, HEIGHT - top);
        if (col > PAD) atomicAdd(&es.bump, abs((lm ? first_bit(lm) : HEIGHT) - top));
      }
    } else {
      const int k = i - o_rows, e = k / HEIGHT, h = k % HEIGHT;
      uint32_t row[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) row[j] = senv[e].rows[h * NW + j];
      if (row_full(row))  // into the mask's 32-bit half that holds row h
        atomicOr(reinterpret_cast<unsigned int*>(&senv[e].full) + (h >> 5), 1u << (h & 31));
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int e = t / A, a = t % A;
  float* sfeat = reinterpret_cast<float*>(sdyn);
  if (e < n_env) {
    const EnvShared& es = senv[e];

    // -- the candidate (_candidate_geometry :93): rotation, column, drop
    const int piece = es.piece;
    int rot = (es.rotation + (a & 3)) % 4;
    if (rot < 0) rot += 4;
    const bool known = piece >= 0 && piece < NP;  // piece_word's and piece_entry's range
    PieceWord pword;
#pragma unroll
    for (int k = 0; k < TW; ++k) pword.w[k] = known ? spacked[(piece * 4 + rot) * TW + k] : 0u;
    const int x = a / 4 + PAD - (known ? sbox[piece] : 0) / 2;
    const int xc = clamp_start(x, PW - S, PW);
    constexpr int z = H - S < 1 ? H - S : 1;  // drop_from_map's least start from the top
    int first_hit = 2 * H;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t prow = piece_row(pword, s);
#pragma unroll
      for (int j = 0; j < S; ++j) {  // the piece's cells only, their loads all in flight
        if ((prow >> j) & 1u) {
          const int r = es.occ_top[(z + s) * PW + xc + j];
          if (r - s <= H - S) first_hit = min(first_hit, r - s);
        }
      }
    }
    const int y = first_hit == 0 ? 0 : min(max(first_hit - 1, 0), H);
    const int yc = clamp_start(y, H - S, H);

    // -- the S rows under the piece, a word at a time: the frame, the stack,
    //    the lock and the full rows
    bool frame_hit = false, stack_hit = false;
    FillMask filled = static_cast<FillMask>(es.full);
    int cells = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int h = yc + i;
      const uint32_t prow = piece_row(pword, i);
      uint32_t sp[NW], locked[NW];
      cells += __popc(prow);
      shift_row(prow, xc, sp);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint32_t staged = es.rows[h * NW + j];
        frame_hit |= ((h < HEIGHT ? side_word(j) : full_word(j)) & sp[j]) != 0u;
        stack_hit |= (staged & sp[j]) != 0u;
        locked[j] = staged | sp[j];
      }
      if (h < HEIGHT)
        filled = (filled & ~(FillMask{1} << h)) | (static_cast<FillMask>(row_full(locked) ? 1u : 0u) << h);
    }
    stack_hit = stack_hit && !frame_hit;
    const int n = popc_fill(filled);
    stack_hit |= n > prm.max_clear;
    const int status = stack_hit ? kOver : (frame_hit ? kIllegal : kPlaced);
    smask[t] = frame_hit ? 0.0f : 1.0f;
    sover[t] = stack_hit ? 1 : 0;
    slines[t] = status == kPlaced ? n : 0;

    if (feat) {
      float* out = features_of(t, sfeat, obs, static_cast<long long>(b0) * A);
      if (status != kPlaced) {
        const float v = status == kIllegal ? static_cast<float>(HEIGHT) : 0.0f;
        for (int c = 0; c <= WIDTH; ++c) out[c] = v;
        out[WIDTH + 1] = 0.0f;
        out[WIDTH + 2] = 0.0f;
      } else if (n == 0) {
        // nothing clears: only the columns under the window change, each to
        // the larger of its old height and the piece's top cell there
        const int c0 = xc - PAD;
        int hn[S], ho[S + 2];  // new heights of the window's columns; old ones from c0 - 1 on
#pragma unroll
        for (int j = 0; j < S + 2; ++j) {
          const int cc = c0 - 1 + j;
          ho[j] = (cc >= 0 && cc < WIDTH) ? HEIGHT - es.top[cc] : 0;
        }
        int sum = es.sum, mx = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          hn[j] = ho[j + 1];
          const int cc = c0 + j;
          if (cc >= 0 && cc < WIDTH) {
            int ptop = HEIGHT;
#pragma unroll
            for (int i = S - 1; i >= 0; --i)
              if ((piece_row(pword, i) >> j) & 1u) ptop = yc + i;
            hn[j] = max(ho[j + 1], HEIGHT - ptop);
            sum += hn[j] - ho[j + 1];
            mx = max(mx, hn[j]);
          }
        }
        int bump = es.bump;
#pragma unroll
        for (int j = 0; j <= S; ++j) {  // the pair (c0 + j - 1, c0 + j)
          const int cc = c0 + j;
          if (cc >= 1 && cc < WIDTH) {
            const int right = j < S ? hn[j] : ho[j + 1];
            const int left = j > 0 ? hn[j - 1] : ho[j];
            bump += abs(right - left) - abs(ho[j + 1] - ho[j]);
          }
        }
        // the other columns' heights as the env has them; no height falls,
        // so the maximum is the env's or a new one
#pragma unroll
        for (int c = 0; c < WIDTH; ++c) out[c] = es.hf[c];
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (c0 + j >= 0 && c0 + j < WIDTH) out[c0 + j] = static_cast<float>(hn[j]);
        out[WIDTH] = static_cast<float>(max(mx, es.maxh));
        out[WIDTH + 1] = static_cast<float>(sum - es.occ - cells);
        out[WIDTH + 2] = static_cast<float>(bump);
      } else {
        // rows clear (0.06-0.08% of candidates): listed for the block's
        // column pass below
        const int k = atomicAdd(&sclear_n, 1);
        sclear[k] = t;
        stotal[0][k] = stotal[1][k] = stotal[2][k] = 0;
      }
    }
    if (!feat || (status == kPlaced && n > 0)) {
      Cand& cd = scand[t];
      cd.filled = filled;
      cd.info = static_cast<uint32_t>(status) | static_cast<uint32_t>(n) << 2 |
                static_cast<uint32_t>(xc) << 9 | static_cast<uint32_t>(yc) << 16;
      cd.word = pword;
    }
  }
  __syncthreads();

  // -- features of the candidates that clear rows, a thread a (candidate,
  //    column): the column's height and holes from its mask, and the
  //    bumpiness term with its left neighbour; the block takes them
  //    together, so that no candidate's thread runs all its columns alone
  const long long first = static_cast<long long>(b0) * A;
  if (feat && sclear_n > 0) {  // the same in every thread of the block
    const int n_clear = sclear_n;
    for (int i = threadIdx.x; i < n_clear * WIDTH; i += blockDim.x) {
      const int k = i / WIDTH, c = i % WIDTH, tc = sclear[k];
      const Cand& cd = scand[tc];
      const EnvShared& es = senv[tc / A];
      int cells;
      const int hgt = cleared_height(es, cd, c, cells);
      features_of(tc, sfeat, obs, first)[c] = static_cast<float>(hgt);
      atomicMax(&stotal[0][k], hgt);
      atomicAdd(&stotal[1][k], hgt - cells);
      if (c > 0) atomicAdd(&stotal[2][k], abs(hgt - cleared_height(es, cd, c - 1, cells)));
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_clear; k += blockDim.x) {
      float* out = features_of(sclear[k], sfeat, obs, first);
      out[WIDTH] = static_cast<float>(stotal[0][k]);
      out[WIDTH + 1] = static_cast<float>(stotal[1][k]);
      out[WIDTH + 2] = static_cast<float>(stotal[2][k]);
    }
    __syncthreads();
  }

  // -- [A, B] outputs: the block's envs are n_env consecutive entries of each
  //    row a, so consecutive threads write consecutive entries
  const int n_cand = n_env * A;  // a multiple of 4
  for (int i = threadIdx.x; i < n_cand; i += blockDim.x) {
    const int a = i / n_env, e = i % n_env;
    const long long ab = static_cast<long long>(a) * B + b0 + e;
    mask[ab] = smask[e * A + a];
    game_over[ab] = sover[e * A + a];
    lines_out[ab] = slines[e * A + a];
  }
  // -- the block's candidates are contiguous in obs: write them together
  if (feat) {
    if constexpr (kStageFeatures) {
      if constexpr (kFeatStride == kFeat) {
        float4* out = reinterpret_cast<float4*>(obs + first * kFeat);
        const float4* in = reinterpret_cast<const float4*>(sfeat);
        for (int i = threadIdx.x; i < n_cand * kFeat / 4; i += blockDim.x) out[i] = in[i];
      } else {
        float* out = obs + first * kFeat;
        for (int i = threadIdx.x; i < n_cand * kFeat; i += blockDim.x)
          out[i] = sfeat[(i / kFeat) * kFeatStride + i % kFeat];
      }
    }
    return;
  }
  uint8_t* chunks = reinterpret_cast<uint8_t*>(sdyn);
  constexpr int kCells = HEIGHT * WIDTH;
  for (int c0 = 0, q = 0; c0 < n_cand; c0 += kChunk, ++q) {
    const int nc = min(kChunk, n_cand - c0);  // a multiple of 4
    uint8_t* buf = chunks + (q % kBuffers) * (kChunk * kCells);
    // with two buffers, the barrier after the last chunk's build ordered
    // this buffer's writes after its stream two chunks ago
    if (kBuffers == 1 && q > 0) __syncthreads();
    for (int i = threadIdx.x; i < nc * HEIGHT * NWF; i += blockDim.x) {
      const int k = i % NWF, cr = i / NWF, c = cr / HEIGHT, r = cr % HEIGHT;
      build_row(buf + cr * WIDTH, scand[c0 + c], senv[(c0 + c) / A], r, k);
    }
    __syncthreads();
    // 4 cells read as a word, written as 4 floats
    float4* out = reinterpret_cast<float4*>(obs + (first + c0) * kCells);
    const uint32_t* in = reinterpret_cast<const uint32_t*>(buf);
    for (int i = threadIdx.x; i < nc * kCells / 4; i += blockDim.x) {
      const uint32_t w = in[i];
      out[i] = make_float4(static_cast<float>(w & 1u), static_cast<float>((w >> 8) & 1u),
                           static_cast<float>((w >> 16) & 1u), static_cast<float>(w >> 24));
    }
  }
}

// Dynamic shared memory of a launch in `mode`.
int dynamic_smem(int mode) {
  if (mode == 0) return kStageFeatures ? kThreads * kFeatStride * 4 : 0;
  return kBuffers * kChunk * kBoardBytes;
}

cudaError_t allow_smem(int bytes) {
  static int opted = 48 * 1024 - kStatic;  // the most dynamic shared memory opted in to so far
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(grouped_placements_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) opted = bytes;
  return rc;
}

// Envs a block for a batch of B: kEnvs, or where B gives the card's SMs
// fewer than kEnvs each, ceil(B / SMs), so that every SM takes a block.
int envs_per_block(int B) { return std::min(kEnvs, std::max(1, (B + sm_count() - 1) / sm_count())); }

}  // namespace

// rows: uint32[H, B] (one word a row) or uint32[H, NW, B]; piece, rotation:
// int32[B]; packed: uint32[NP * 4 * TW]; box: int32[NP]; obs: float32[B, A,
// WIDTH + 3] or [B, A, HEIGHT, WIDTH] (16-byte aligned); mask: float32[A, B];
// game_over: bool[A, B]; lines: int32[A, B].
extern "C" int grouped_placements_launch(const void* rows, const void* piece,
                                         const void* rotation, const void* packed,
                                         const void* box, void* obs, void* mask,
                                         void* game_over, void* lines, int B,
                                         const PlacementParams* params, void* stream) {
  const PlacementParams prm = *params;
  const int smem = dynamic_smem(prm.mode);
  const cudaError_t rc = allow_smem(smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int envs = envs_per_block(B);
  const int blocks = (B + envs - 1) / envs;
  grouped_placements_kernel<<<blocks, envs * A, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(box), static_cast<float*>(obs), static_cast<float*>(mask),
      static_cast<uint8_t*>(game_over), static_cast<int32_t*>(lines), B, prm);
  return static_cast<int>(cudaGetLastError());
}

// The build's shape: out = [envs a block, threads a block, static shared
// memory, candidates a boards chunk, boards buffers, features staged (0/1),
// then for the features and the boards mode their dynamic shared memory and
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)].
extern "C" int grouped_placements_occupancy(int* out) {
  out[0] = kEnvs;
  out[1] = kThreads;
  out[2] = kStatic;
  out[3] = kChunk;
  out[4] = kBuffers;
  out[5] = kStageFeatures ? 1 : 0;
  for (int k = 0; k < 2; ++k) {
    const int smem = dynamic_smem(k);
    cudaError_t rc = allow_smem(smem);
    int blocks = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grouped_placements_kernel, kThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    out[6 + 2 * k] = smem;
    out[7 + 2 * k] = blocks;
  }
  return 0;
}
