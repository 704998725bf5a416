// Placements and the grouped observation of the flagship engine for Hopper
// (sm_90a): an env's shared work once, then one thread per (env, candidate).
//
// Replaces tetris_gymnasium_tpu/core/grouped.py:placements (:98) with
// _candidate (:68) and _frame_overlap (:57) over the one-hot
// ops/board.py:drop_distance (:116), collision (:62), project (:80) and
// clear_lines (:166), and grouped_observation (:113) in its boards and
// features modes (feature_vector, ops/observations.py:57).  For each of the
// A = WIDTH * 4 (column, rotation) candidates of every env it drops the
// active piece from the top, tests the resting window against the bedrock
// frame (id 1 under a piece cell: illegal) and the stack (a cell > 0: a
// legal game-over placement), locks the piece by ADDING its id into the
// window (int8 wrap), clears every full row (no envelope) and writes:
//   mode 0, features: float32[B, A, n] of the cropped cleared board, under
//     any FeatureFlags (features.cuh);
//   mode 1, boards: float32[B, A, H, PW] padded id boards;
//   mode 2, ids: the same boards as int8 (the grouped rgb mode views them
//     as uint8 and composites them with compose_rgb).
// An illegal candidate's board is all ones, its padding too (features:
// heights HEIGHT, max HEIGHT, holes 0, bumpiness 0); a game-over one's all
// zeros.  Every mode writes mask float32[B, A], game_over bool[B, A] and
// lines int32[B, A].  The plain PyTorch twins are
// tetris_gymnasium_torch/core/grouped.py:placements_plain and
// grouped_observation_plain; every output is bit-equal to them.
//
// On the TPU each candidate is a vmapped lane of one-hot contractions, with
// the A boards of an env materialised in HBM and cleared by a permutation
// matmul.  Here a block takes kEnvs envs (6 at 10x20) and stages their
// boards, their pieces and the piece tables in shared memory.  What all A
// candidates of an env share is built once, in one pass over the staged
// board (EnvShared): the rows' occupancy (> 0) and filled (!= 0) words, the
// full rows and each row's count of filled cells, for each padded column
// the first occupied row at or below each of the first S + 1 rows (the
// drop), and in features mode for each playfield column the first filled
// row at or below every row, and the heights with their sum and bumpiness.
// Each thread then runs its candidate:
//   - the drop from those column tops: a piece cell (s, j) first meets the
//     stack at the start (first occupied row >= 1 + s of its column) - s,
//     the hit map of the one-hot version at its least start >= 1; only the
//     piece's cells are visited (the set bits of its rows), not its S x S box;
//   - the cells under the piece as words: the frame and the stack are the
//     piece rows ANDed with the staged rows' id-1 and occupancy words, and
//     the window rows' occupancy and filled words after the lock are the
//     staged ones ORed with the piece rows (a piece cell on a negative id,
//     whose sum may wrap, is patched cell by cell; no cell-by-cell sum of
//     the S rows);
//   - the full rows: the env's outside the window, the patched rows inside.
// Features: a candidate that clears nothing changes only the (<= S)
// columns under its window, so it patches the env's heights there (a
// column's new top is its old one above the window, else its first filled
// window row, else the first filled row below the window) and the sum,
// bumpiness (the S + 1 pairs around the window), maximum (the other
// columns' as it copies their heights) and filled count (the window rows')
// from the env's; a candidate that clears rows folds its kept rows into the
// bit-sliced height counters of features.cuh, rows that every candidate of
// the env shares read from the staged words.  The block stages its
// candidates' vectors and writes them together in 16-byte stores.
// Boards and ids: an output row of a candidate is the bedrock, zeros (a
// cleared row) or one staged row (its source, the (r - n)-th kept row) with
// the piece's id added in the S rows of its window, so the block builds
// chunks of its candidates' int8 boards in shared memory a row a thread,
// then streams each chunk out as one contiguous run: 16-byte stores of 4
// floats from 4 bytes read as a word (boards), or the bytes themselves
// (ids).  A chunk holds a multiple of 4 candidates, so a chunk starts on a
// 16-byte boundary of either output though a row (PW bytes) need not.
//
// Bound on this card: bytes in the board modes (an env writes 4 A H PW
// bytes of float32 boards: 69,120 at 10x20, 437,760 at 30x20), operations
// in features mode.
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per
// geometry): padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces, a padded board of <= 3072 cells.  What other geometries
// change here:
//   - rows of NW words and piece entries of TW words (engine_common.cuh);
//     the mask of full rows is 64-bit past 32 playfield rows (FillMask); a
//     playfield row mask is NWF = ceil(WIDTH / 32) words, the bit of a
//     run-time column chosen among them by constant indices;
//   - envs a block: as many as 256 threads take (6 at 10x20, 2 at 30x20,
//     1 from width 33); the features are staged where the block's vectors
//     fit in shared memory with what else it holds (all but the widest
//     boards), else each thread stores its own; a boards chunk is the
//     block's candidates or kChunkBytes of boards, whichever is less;
//   - a block's boards start on a 16-byte boundary only where BOARD allows
//     (engine_common.cuh:block_copy); ids go out in 16-byte stores where
//     BOARD is a multiple of 4, else in 4-byte ones.

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"
#include "features.cuh"

using namespace engine;

namespace {

constexpr int A = WIDTH * 4;      // candidates an env
constexpr int BOARD = H * PW;     // bytes of a padded board: 432 by default
constexpr int kMaxFeatures = WIDTH + 3;
using Acc = features::Acc<HEIGHT, WIDTH>;
constexpr int NWF = Acc::NWF;     // words of a playfield row mask
constexpr int kOccRows = S + 1;   // occupancy tops are read from rows 0..S only
enum : int { kFeatures = 0, kBoards = 1, kIds = 2 };
enum : int { kPlaced = 0, kIllegal = 1, kOver = 2 };

// What the A candidates of an env share, built once a block.
struct EnvShared {
  unsigned long long full;              // full playfield rows (occupancy), as a FillMask
  int sum, bump, occ;                   // heights' sum and bumpiness, filled playfield cells
  int piece, rotation;
  uint32_t rows[H * NW];                // occupancy (> 0) of each padded row
  uint32_t nz[H * NW];                  // filled cells (!= 0) of each padded row
  uint32_t ones[H * NW];                // cells of id 1 (the bedrock's) of each padded row
  float hf[WIDTH];                      // heights, as the features write them
  uint8_t occ_top[kOccRows * PW];       // first occupied row >= r of each padded column (H: none)
  uint8_t top[(HEIGHT + 1) * WIDTH];    // first filled row >= y of each playfield column (HEIGHT: none)
  uint8_t row_cnt[HEIGHT];              // filled cells of each playfield row
};

// A candidate's placement, as the boards writer reads it.
struct Cand {
  FillMask filled;                      // its full rows
  uint32_t info;                        // status | n << 2 | xc << 9 | yc << 16 | uint8(pid) << 24
  PieceWord word;
};

constexpr int kEnvs = 256 / A > 1 ? 256 / A : 1;  // envs a block
constexpr int kThreads = kEnvs * A;
constexpr int kTable = NP * 4 * TW;   // words of the packed piece table
constexpr int kStatic = kEnvs * (BOARD + static_cast<int>(sizeof(EnvShared))) +
                        kThreads * static_cast<int>(sizeof(Cand)) + 4 * (kTable + 2 * NP);
static_assert(kStatic <= 46 * 1024, "grouped_flagship: a block's static shared memory passes 46 KB");
// Dynamic shared memory: the block's feature vectors, or a chunk of boards.
constexpr int kMaxSmem = 227 * 1024;
constexpr int kFeatStage = kThreads * (kMaxFeatures | 1) * 4;
constexpr bool kStageFeatures = kStatic + kFeatStage <= 160 * 1024;
constexpr int kChunkBytes = 24 * 1024;
constexpr int kChunkByBytes = (kChunkBytes / BOARD) & ~3;
constexpr int kChunk = kChunkByBytes < 4 ? 4 : (kChunkByBytes < kThreads ? kChunkByBytes : kThreads);
static_assert(kThreads % 4 == 0 && kStatic + kChunk * BOARD <= kMaxSmem, "grouped_flagship: chunk");

__device__ __forceinline__ bool bit_of(const uint32_t (&m)[NWF], int c) {
  bool v = false;
#pragma unroll
  for (int k = 0; k < NWF; ++k) v = (c >> 5) == k ? ((m[k] >> (c & 31)) & 1u) != 0 : v;
  return v;
}

__device__ __forceinline__ void set_bit(uint32_t (&m)[NWF], int c, bool on) {
#pragma unroll
  for (int k = 0; k < NWF; ++k) {
    const uint32_t b = (c >> 5) == k ? 1u << (c & 31) : 0u;
    m[k] = on ? (m[k] | b) : (m[k] & ~b);
  }
}

__device__ __forceinline__ void crop(const uint32_t* row, uint32_t (&m)[NWF]) {
  uint32_t r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = row[j];
  features::crop_row<NW, PAD, WIDTH>(r, m);
}

__device__ __forceinline__ void fill_bytes(int8_t* dst, int8_t v) {
#pragma unroll
  for (int c = 0; c < PW; ++c) dst[c] = v;
}

// Row r of a candidate's output board into dst (PW bytes).
__device__ __forceinline__ void build_row(int8_t* dst, const Cand& cd, const int8_t* bd, int r) {
  const int status = cd.info & 3u;
  if (status == kOver) return fill_bytes(dst, 0);
  if (status == kIllegal || r >= HEIGHT) return fill_bytes(dst, 1);
  const int n = (cd.info >> 2) & 127u;
#pragma unroll
  for (int c = 0; c < PAD; ++c) dst[c] = dst[PAD + WIDTH + c] = 1;
  if (r < n) {
#pragma unroll
    for (int c = PAD; c < PAD + WIDTH; ++c) dst[c] = 0;
    return;
  }
  const int s = n == 0 ? r : kept_row(cd.filled, r - n);
  const int8_t* src = bd + s * PW;
  const int xc = (cd.info >> 9) & 127u, yc = (cd.info >> 16) & 255u;
  const int i = s - yc;
  const uint32_t prow = (i >= 0 && i < S) ? piece_row(cd.word, i) : 0u;
  if (prow == 0u) {
#pragma unroll
    for (int c = PAD; c < PAD + WIDTH; ++c) dst[c] = src[c];
    return;
  }
  uint32_t pm[NW];  // the piece row at its columns
  shift_row(prow, xc, pm);
  const int pid = static_cast<int8_t>(cd.info >> 24);
#pragma unroll
  for (int c = PAD; c < PAD + WIDTH; ++c)
    dst[c] = static_cast<int8_t>(src[c] + (((pm[c / 32] >> (c % 32)) & 1u) ? pid : 0));
}

// Words between two candidates' staged vectors: odd, so that the threads of
// a warp, each writing its own vector, hit 32 distinct banks.
__host__ __device__ __forceinline__ int feat_stride(int n_feat) { return n_feat | 1; }

__device__ __forceinline__ float s8(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

__global__ void __launch_bounds__(kThreads) grouped_flagship_kernel(
    const int8_t* __restrict__ boards, const int32_t* __restrict__ piece_in,
    const int32_t* __restrict__ rotation_in, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ box, const int32_t* __restrict__ ids, void* __restrict__ obs,
    float* __restrict__ mask, uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out,
    int B, int mode, int flags) {
  __shared__ __align__(16) int8_t sboard[kEnvs * BOARD];
  __shared__ EnvShared senv[kEnvs];
  __shared__ Cand scand[kThreads];
  __shared__ uint32_t spacked[kTable];
  __shared__ int sbox[NP], sids[NP];
  extern __shared__ __align__(16) unsigned char sdyn[];  // feature vectors or a chunk of boards

  const int b0 = blockIdx.x * kEnvs;
  const int n_env = min(kEnvs, B - b0);
  const bool feat = mode == kFeatures;
  // the boards, the envs' pieces and the piece tables, all loads in flight at once
  block_copy(sboard, boards + static_cast<size_t>(b0) * BOARD, n_env * BOARD);
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) spacked[i] = __ldg(packed + i);
  for (int i = threadIdx.x; i < NP; i += blockDim.x) {
    sbox[i] = __ldg(box + i);
    sids[i] = __ldg(ids + i);
  }
  for (int e = threadIdx.x; e < n_env; e += blockDim.x) {
    EnvShared& es = senv[e];
    es.piece = piece_in[b0 + e];
    es.rotation = rotation_in[b0 + e];
    es.full = 0;
    es.sum = es.bump = es.occ = 0;
  }
  __syncthreads();

  // -- an env's shared work, in one pass over its staged board, one job a
  //    thread, each kind of job starting on a warp of its own (so that a
  //    warp runs one kind): in features mode each playfield column's filled
  //    tops, height, count and bumpiness term; each padded column's
  //    occupancy tops; the rows' words; the full rows and the rows' counts
  auto warps = [](int n) { return (n + 31) & ~31; };
  const int n_top = feat ? n_env * WIDTH : 0, n_occ = n_env * PW, n_words = n_env * H * NW;
  const int o_occ = warps(n_top), o_words = o_occ + warps(n_occ), o_full = o_words + warps(n_words);
  for (int i = threadIdx.x; i < o_full + n_env * HEIGHT; i += blockDim.x) {
    if (i < o_occ) {
      if (i >= n_top) continue;
      const int e = i / WIDTH, c = i % WIDTH;
      const int8_t* bd = sboard + e * BOARD + PAD + c;
      EnvShared& es = senv[e];
      int first = HEIGHT, left = HEIGHT, cnt = 0;  // left: the top of column c - 1
      es.top[HEIGHT * WIDTH + c] = HEIGHT;
#pragma unroll
      for (int y = HEIGHT - 1; y >= 0; --y) {
        if (bd[y * PW] != 0) {
          first = y;
          ++cnt;
        }
        if (c > 0 && bd[y * PW - 1] != 0) left = y;
        es.top[y * WIDTH + c] = static_cast<uint8_t>(first);
      }
      es.hf[c] = static_cast<float>(HEIGHT - first);
      atomicAdd(&es.sum, HEIGHT - first);
      atomicAdd(&es.occ, cnt);
      if (c > 0) atomicAdd(&es.bump, abs(left - first));
    } else if (i < o_words) {
      const int k = i - o_occ, e = k / PW, col = k % PW;
      if (k >= n_occ) continue;
      const int8_t* bd = sboard + e * BOARD;
      int first = H;
#pragma unroll
      for (int r = H - 1; r >= 0; --r) {
        if (bd[r * PW + col] > 0) first = r;
        if (r < kOccRows) senv[e].occ_top[r * PW + col] = static_cast<uint8_t>(first);
      }
    } else if (i < o_full) {
      const int k = i - o_words, e = k / (H * NW), hj = k % (H * NW), j = hj % NW;
      if (k >= n_words) continue;
      const int8_t* row = sboard + e * BOARD + (hj / NW) * PW;
      uint32_t r = 0, nz = 0, one = 0;
#pragma unroll
      for (int w = 0; w < 32; ++w) {
        const int col = 32 * j + w;
        if (col < PW) {
          r |= (row[col] > 0 ? 1u : 0u) << w;
          nz |= (row[col] != 0 ? 1u : 0u) << w;
          one |= (row[col] == 1 ? 1u : 0u) << w;
        }
      }
      senv[e].rows[hj] = r;
      senv[e].nz[hj] = nz;
      senv[e].ones[hj] = one;
    } else {
      const int k = i - o_full, e = k / HEIGHT, h = k % HEIGHT;
      const int8_t* row = sboard + e * BOARD + h * PW + PAD;
      bool full = true;
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) {
        full &= row[c] > 0;
        cnt += row[c] != 0 ? 1 : 0;
      }
      if (full) atomicOr(&senv[e].full, 1ull << h);
      senv[e].row_cnt[h] = static_cast<uint8_t>(cnt);
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int e = t / A, a = t % A;
  const int n_feat = features::n_features(WIDTH, flags);
  const int stride = feat_stride(n_feat);
  float* sfeat = reinterpret_cast<float*>(sdyn);
  if (e < n_env) {
    const int b = b0 + e;
    const int8_t* bd = sboard + e * BOARD;
    const EnvShared& es = senv[e];

    // -- the candidate (_candidate :68): rotation, column, drop from the top
    const int piece = es.piece;
    int rot = (es.rotation + (a & 3)) % 4;
    if (rot < 0) rot += 4;
    const bool known = piece >= 0 && piece < NP;  // piece_word_2d's and piece_entry's range
    PieceWord pword;
#pragma unroll
    for (int k = 0; k < TW; ++k) pword.w[k] = known ? spacked[(piece * 4 + rot) * TW + k] : 0u;
    const int x = a / 4 + PAD - (known ? sbox[piece] : 0) / 2;
    const int xc = clamp_start(x, PW - S, PW);
    constexpr int z = H - S < 1 ? H - S : 1;  // drop_from_map's least start from the top
    int first_hit = 2 * H;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      for (uint32_t m = piece_row(pword, s); m; m &= m - 1u) {  // the piece's cells only
        const int r = es.occ_top[(z + s) * PW + xc + __ffs(m) - 1];
        if (r - s <= H - S) first_hit = min(first_hit, r - s);
      }
    }
    const int y = first_hit == 0 ? 0 : min(max(first_hit - 1, 0), H);
    const int yc = clamp_start(y, H - S, H);
    const int pid = known ? sids[piece] : 0;

    // -- the cells under the piece, a word at a time: the frame (a piece cell
    //    on id 1), the stack (on a cell > 0) and the lock.  On an empty cell
    //    the piece's id (> 0) leaves the cell occupied and filled, so the
    //    window rows' occupancy (pos) and filled (win) words are the staged
    //    ones ORed with the piece row.  Where a piece cell lies on a negative
    //    id, whose sum may wrap to 0 or stay negative, or the id is not
    //    positive as an int8, the cells under the piece are patched one by one
    const int8_t pid8 = static_cast<int8_t>(pid);
    bool frame_hit = false, stack_hit = false, odd = pid8 <= 0;
    uint32_t pos[S][NWF], win[S][NWF];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int h = yc + i;
      uint32_t sp[NW], po[NW], wi[NW];
      shift_row(piece_row(pword, i), xc, sp);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint32_t occ = es.rows[h * NW + j], nz = es.nz[h * NW + j];
        frame_hit |= (es.ones[h * NW + j] & sp[j]) != 0u;
        stack_hit |= (occ & sp[j]) != 0u;
        odd |= (nz & ~occ & sp[j]) != 0u;
        po[j] = occ | sp[j];
        wi[j] = nz | sp[j];
      }
      features::crop_row<NW, PAD, WIDTH>(po, pos[i]);
      features::crop_row<NW, PAD, WIDTH>(wi, win[i]);
    }
    if (odd) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int h = yc + i;
        crop(es.rows + h * NW, pos[i]);
        crop(es.nz + h * NW, win[i]);
        for (uint32_t m = piece_row(pword, i); m; m &= m - 1u) {
          const int cc = xc + __ffs(m) - 1 - PAD;
          if (cc >= 0 && cc < WIDTH) {
            const int8_t v = static_cast<int8_t>(bd[h * PW + PAD + cc] + pid);
            set_bit(pos[i], cc, v > 0);
            set_bit(win[i], cc, v != 0);
          }
        }
      }
    }
    FillMask filled = static_cast<FillMask>(es.full);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int h = yc + i;
      if (h < HEIGHT) {
        bool full = true;
#pragma unroll
        for (int k = 0; k < NWF; ++k) full &= pos[i][k] == features::full_row_word<WIDTH>(k);
        filled = (filled & ~(FillMask{1} << h)) | (static_cast<FillMask>(full ? 1u : 0u) << h);
      }
    }
    const int n = popc_fill(filled);
    const int status = frame_hit ? kIllegal : (stack_hit ? kOver : kPlaced);
    const long long ab = static_cast<long long>(b) * A + a;
    mask[ab] = frame_hit ? 0.0f : 1.0f;
    game_over[ab] = status == kOver ? 1 : 0;
    lines_out[ab] = status == kPlaced ? n : 0;

    if (feat) {
      float* out = kStageFeatures ? sfeat + t * stride : static_cast<float*>(obs) + ab * n_feat;
      int k = (flags & features::kHeight) ? WIDTH : 0;
      if (status != kPlaced) {
        const float v = status == kIllegal ? static_cast<float>(HEIGHT) : 0.0f;
        for (int c = 0; c < k; ++c) out[c] = v;
        if (flags & features::kMaxHeight) out[k++] = v;
        if (flags & features::kHoles) out[k++] = 0.0f;
        if (flags & features::kBumpiness) out[k++] = 0.0f;
      } else if (n == 0) {
        // nothing clears: only the columns under the window change
        const int c0 = xc - PAD;
        const int yb = min(yc + S, HEIGHT);
        int hn[S], ho[S + 2];  // new heights of the window's columns; old ones from c0 - 1 on
#pragma unroll
        for (int j = 0; j < S + 2; ++j) {
          const int cc = c0 - 1 + j;
          ho[j] = (cc >= 0 && cc < WIDTH) ? HEIGHT - es.top[cc] : 0;
        }
        int sum = es.sum, mx = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int cc = c0 + j;
          hn[j] = ho[j + 1];
          if (cc >= 0 && cc < WIDTH) {
            int tp = es.top[cc];
            if (tp >= yc) {
              tp = es.top[yb * WIDTH + cc];
#pragma unroll
              for (int i = S - 1; i >= 0; --i)
                if (yc + i < HEIGHT && bit_of(win[i], cc)) tp = yc + i;
            }
            hn[j] = HEIGHT - tp;
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
        int occ = es.occ;
#pragma unroll
        for (int i = 0; i < S; ++i) {
          if (yc + i < HEIGHT) {
#pragma unroll
            for (int w = 0; w < NWF; ++w) occ += __popc(win[i][w]);
            occ -= es.row_cnt[yc + i];
          }
        }
        // the other columns' heights as the env has them, and their maximum
        float fmx = static_cast<float>(mx);
        for (int c = 0; c < WIDTH; ++c) {
          const float h = es.hf[c];
          if (k) out[c] = h;
          if (static_cast<unsigned>(c - c0) >= static_cast<unsigned>(S)) fmx = fmaxf(fmx, h);
        }
        if (k) {
#pragma unroll
          for (int j = 0; j < S; ++j)
            if (c0 + j >= 0 && c0 + j < WIDTH) out[c0 + j] = static_cast<float>(hn[j]);
        }
        if (flags & features::kMaxHeight) out[k++] = fmx;
        if (flags & features::kHoles) out[k++] = static_cast<float>(sum - occ);
        if (flags & features::kBumpiness) out[k++] = static_cast<float>(bump);
      } else {
        // rows clear: the kept rows, top-down (the cleared rows above them
        // are zeros), folded into the height counters
        Acc acc;
        acc.init();
#pragma unroll
        for (int h = 0; h < HEIGHT; ++h) {
          if ((filled >> h) & 1u) continue;
          const int i = h - yc;
          uint32_t m[NWF];
          if (i >= 0 && i < S) {
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int w = 0; w < NWF; ++w) m[w] = s == i ? win[s][w] : m[w];
          } else {
            crop(es.nz + h * NW, m);
          }
          acc.add_row(m);
        }
        acc.write(flags, out);
      }
    } else {
      Cand& cd = scand[t];
      cd.filled = filled;
      cd.info = static_cast<uint32_t>(status) | static_cast<uint32_t>(n) << 2 |
                static_cast<uint32_t>(xc) << 9 | static_cast<uint32_t>(yc) << 16 |
                static_cast<uint32_t>(static_cast<uint8_t>(pid)) << 24;
      cd.word = pword;
    }
  }
  __syncthreads();

  // -- the block's candidates are contiguous in obs: write them together
  const int n_cand = n_env * A;  // a multiple of 4
  const long long first = static_cast<long long>(b0) * A;
  if (feat) {
    if constexpr (kStageFeatures) {
      if (stride == n_feat) {
        float4* out = reinterpret_cast<float4*>(static_cast<float*>(obs) + first * n_feat);
        const float4* in = reinterpret_cast<const float4*>(sfeat);
        for (int i = threadIdx.x; i < n_cand * n_feat / 4; i += blockDim.x) out[i] = in[i];
      } else {
        float* out = static_cast<float*>(obs) + first * n_feat;
        for (int i = threadIdx.x; i < n_cand * n_feat; i += blockDim.x)
          out[i] = sfeat[(i / n_feat) * stride + i % n_feat];
      }
    }
    return;
  }
  int8_t* chunk = reinterpret_cast<int8_t*>(sdyn);
  for (int c0 = 0; c0 < n_cand; c0 += kChunk) {
    const int nc = min(kChunk, n_cand - c0);  // a multiple of 4
    if (c0) __syncthreads();  // the last chunk is out of shared memory
    for (int i = threadIdx.x; i < nc * H; i += blockDim.x) {
      const int c = i / H, r = i % H;
      build_row(chunk + c * BOARD + r * PW, scand[c0 + c], sboard + ((c0 + c) / A) * BOARD, r);
    }
    __syncthreads();
    const int words = nc * BOARD / 4;
    const uint32_t* in = reinterpret_cast<const uint32_t*>(chunk);
    if (mode == kBoards) {
      float4* out = reinterpret_cast<float4*>(static_cast<float*>(obs) + (first + c0) * BOARD);
      for (int i = threadIdx.x; i < words; i += blockDim.x) {
        const uint32_t w = in[i];
        out[i] = make_float4(s8(w, 0), s8(w, 1), s8(w, 2), s8(w, 3));
      }
    } else if constexpr (BOARD % 4 == 0) {
      uint4* out = reinterpret_cast<uint4*>(static_cast<int8_t*>(obs) + (first + c0) * BOARD);
      const uint4* in4 = reinterpret_cast<const uint4*>(chunk);
      for (int i = threadIdx.x; i < words / 4; i += blockDim.x) out[i] = in4[i];
    } else {
      uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<int8_t*>(obs) + (first + c0) * BOARD);
      for (int i = threadIdx.x; i < words; i += blockDim.x) out[i] = in[i];
    }
  }
}

// Dynamic shared memory of a launch in `mode` with n_feat features.
int dynamic_smem(int mode, int n_feat) {
  if (mode == kFeatures) return kStageFeatures ? kThreads * feat_stride(n_feat) * 4 : 0;
  return kChunk * BOARD;
}

cudaError_t allow_smem(int bytes) {
  static int opted = 48 * 1024 - kStatic;  // the most dynamic shared memory opted in to so far
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(grouped_flagship_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) opted = bytes;
  return rc;
}

}  // namespace

// boards: int8[B, H, PW] (16-byte aligned); piece, rotation: int32[B];
// packed: uint32[NP * 4 * TW]; box, ids: int32[NP]; obs: float32[B, A, n]
// (mode 0), float32[B, A, H, PW] (mode 1) or int8[B, A, H, PW] (mode 2);
// mask: float32[B, A]; game_over: bool[B, A]; lines: int32[B, A].
extern "C" int grouped_flagship_launch(const void* boards, const void* piece, const void* rotation,
                                       const void* packed, const void* box, const void* ids,
                                       void* obs, void* mask, void* game_over, void* lines, int B,
                                       int mode, int flags, void* stream) {
  const int smem = dynamic_smem(mode, features::n_features(WIDTH, flags));
  const cudaError_t rc = allow_smem(smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (B + kEnvs - 1) / kEnvs;
  grouped_flagship_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(box), static_cast<const int32_t*>(ids), obs,
      static_cast<float*>(mask), static_cast<uint8_t*>(game_over), static_cast<int32_t*>(lines), B,
      mode, flags);
  return static_cast<int>(cudaGetLastError());
}

// The build's shape: out = [envs a block, threads a block, static shared
// memory, candidates a boards chunk, features staged (0/1), then for the
// features mode (all flags) and the boards mode their dynamic shared memory
// and blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)].
extern "C" int grouped_flagship_occupancy(int* out) {
  out[0] = kEnvs;
  out[1] = kThreads;
  out[2] = kStatic;
  out[3] = kChunk;
  out[4] = kStageFeatures ? 1 : 0;
  for (int k = 0; k < 2; ++k) {
    const int smem = dynamic_smem(k == 0 ? kFeatures : kBoards, kMaxFeatures);
    cudaError_t rc = allow_smem(smem);
    int blocks = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grouped_flagship_kernel, kThreads, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    out[5 + 2 * k] = smem;
    out[6 + 2 * k] = blocks;
  }
  return 0;
}
