// Placements and the grouped observation of the flagship engine for Hopper
// (sm_90a): one thread per (env, candidate), on id boards.
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
// matmul.  Here a block takes kEnvs envs (6 at 10x20): it stages their
// boards in shared memory and packs each into H x NW occupancy words once
// (engine_common.cuh, as flagship_step.cu does); each thread runs the
// flagship step's bit logic on its candidate (hit map, drop, collision),
// sums only the S rows of the piece's window cell by cell and keeps nothing
// of its board but the mask of full rows, the window rows' filled cells
// and, for the board modes, the source row of each output row in shared
// memory.  The features mode folds the rows that stay into the height
// counters as WIDTH-bit masks: window rows from its sums, the others
// cropped from the staged rows' filled-cell words.  The block then writes
// its candidates' outputs, which are contiguous, together: 16-byte stores
// (4-byte for ids), neighbouring threads on neighbouring words, each cell
// read back from the staged board with the piece's id added where the
// piece lies.
//
// Bound on this card: bytes in the board modes (an env writes 4 A H PW
// bytes of float32 boards: 69,120 at 10x20, 437,760 at 30x20), operations
// in features mode (~850 integer operations a candidate at 10x20).
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines with flagship=True, one library per
// geometry): padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces, a padded board of <= 3072 cells.  What other geometries
// change here:
//   - rows of NW words and piece entries of TW words (engine_common.cuh's
//     helpers over rows[H][NW]); the mask of full rows is 64-bit past 32
//     playfield rows (FillMask); a window row's filled cells are NWF =
//     ceil(WIDTH / 32) words, chosen by constant indices;
//   - envs a block: as many as 256 threads take (6 at 10x20, 2 at 30x20,
//     1 from width 33), fewer where their shared memory would pass 48 KB;
//     the features are staged for coalesced stores where A * (WIDTH + 3)
//     floats fit beside the rest (not at 61x12), else each thread stores
//     its own;
//   - a block's boards start on a 16-byte boundary only where BOARD allows
//     (engine_common.cuh:block_copy); the outputs' 16-byte and 4-byte
//     stores are always aligned, since A is a multiple of 4.

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

// Shared memory: an env's staged board and its packed rows; a candidate's
// source rows and pose (board modes) and, where they fit, its features.
constexpr int kSmemBudget = 48 * 1024 - 256;
constexpr int kEnvBytes = BOARD + 2 * 4 * H * NW;
constexpr int kCandBytes = HEIGHT + 4 * (4 + TW);
constexpr int kFeatBytes = 4 * kMaxFeatures;
constexpr bool kStageFeatures = kEnvBytes + A * (kCandBytes + kFeatBytes) <= kSmemBudget;
constexpr int kPerEnv = kEnvBytes + A * (kCandBytes + (kStageFeatures ? kFeatBytes : 0));
constexpr int kEnvsByThreads = 256 / A > 1 ? 256 / A : 1;
constexpr int kEnvsBySmem = kSmemBudget / kPerEnv > 1 ? kSmemBudget / kPerEnv : 1;
constexpr int kEnvs = kEnvsByThreads < kEnvsBySmem ? kEnvsByThreads : kEnvsBySmem;  // envs a block
constexpr int kThreads = kEnvs * A;
static_assert(kEnvs * kPerEnv <= kSmemBudget, "grouped_flagship: a block's shared memory passes 48 KB");
enum : int { kFeatures = 0, kBoards = 1, kIds = 2 };
enum : int { kPlaced = 0, kIllegal = 1, kOver = 2 };

// Cell (r, c) of an env's board after its candidate's lock and clear, given
// where the output row came from (src < 0: a cleared row, zeros).
__device__ __forceinline__ int8_t cleared_cell(const int8_t* bd, int src, int c, const PieceWord& word,
                                               int xc, int yc, int pid) {
  if (c < PAD || c >= PAD + WIDTH || src >= HEIGHT) return 1;  // the rebuilt bedrock
  if (src < 0) return 0;
  int v = bd[src * PW + c];
  const int i = src - yc, j = c - xc;
  if (i >= 0 && i < S && j >= 0 && j < S && ((piece_row(word, i) >> j) & 1u)) v += pid;
  return static_cast<int8_t>(v);
}

__global__ void __launch_bounds__(kThreads) grouped_flagship_kernel(
    const int8_t* __restrict__ boards, const int32_t* __restrict__ piece_in,
    const int32_t* __restrict__ rotation_in, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ box, const int32_t* __restrict__ ids, void* __restrict__ obs,
    float* __restrict__ mask, uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out,
    int B, int mode, int flags) {
  __shared__ __align__(16) int8_t sboard[kEnvs * BOARD];
  __shared__ uint32_t srows[kEnvs * H * NW];     // occupancy (> 0) of each padded row
  __shared__ uint32_t snz[kEnvs * H * NW];       // filled cells (!= 0) of each padded row
  __shared__ int8_t ssrc[kThreads * HEIGHT];     // source row of each output row
  __shared__ int sstatus[kThreads], sxc[kThreads], syc[kThreads], spid[kThreads];
  __shared__ uint32_t sword[kThreads * TW];
  __shared__ float sfeat[kStageFeatures ? kThreads * kMaxFeatures : 1];

  const int b0 = blockIdx.x * kEnvs;
  const int n_env = min(kEnvs, B - b0);
  block_copy(sboard, boards + static_cast<size_t>(b0) * BOARD, n_env * BOARD);
  __syncthreads();
  for (int i = threadIdx.x; i < n_env * H * NW; i += blockDim.x) {
    const int j = i % NW;
    const int8_t* row = sboard + (i / NW) * PW;  // env i / (H NW), row i / NW % H
    uint32_t r = 0, nz = 0;
#pragma unroll
    for (int w = 0; w < 32; ++w) {
      const int col = 32 * j + w;
      if (col < PW) {
        r |= (row[col] > 0 ? 1u : 0u) << w;
        nz |= (row[col] != 0 ? 1u : 0u) << w;
      }
    }
    srows[i] = r;
    snz[i] = nz;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int e = t / A, a = t % A;
  const int n_feat = features::n_features(WIDTH, flags);
  if (e < n_env) {
    const int b = b0 + e;
    const int8_t* bd = sboard + e * BOARD;
    Rows rows;
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int j = 0; j < NW; ++j) rows[h][j] = srows[(e * H + h) * NW + j];

    // -- the candidate (_candidate :68): rotation, column, drop from the top
    const int piece = piece_in[b];
    int rot = (rotation_in[b] + (a & 3)) % 4;
    if (rot < 0) rot += 4;
    const PieceWord pword = piece_word_2d(packed, piece, rot);
    const int x = a / 4 + PAD - piece_entry(box, piece) / 2;
    const HitMask hm = hit_map(rows, pword, x);
    const int y = drop_from_map(hm, 0);
    const int xc = clamp_start(x, PW - S, PW);
    const int yc = clamp_start(y, H - S, H);
    const int pid = piece_entry(ids, piece);

    bool frame_hit = false;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const uint32_t prow = piece_row(pword, i);
#pragma unroll
      for (int j = 0; j < S; ++j)
        frame_hit |= ((prow >> j) & 1u) && bd[(yc + i) * PW + xc + j] == 1;
    }
    const bool stack_hit = collision_at(hm, y);

    // -- lock and clear: the full rows of the stamped board.  The S rows of
    //    the piece's window are summed cell by cell (their filled playfield
    //    cells kept as masks in `win`); the others are the staged rows
    FillMask filled = 0;
    uint32_t win[S][NWF];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int h = yc + i;
      const uint32_t prow = piece_row(pword, i);
      uint32_t pos[NWF];
#pragma unroll
      for (int k = 0; k < NWF; ++k) pos[k] = win[i][k] = 0u;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) {
        const int j = PAD + c - xc;
        int v = bd[h * PW + PAD + c];
        if (j >= 0 && j < S && ((prow >> j) & 1u)) v += pid;
        pos[c / 32] |= (static_cast<int8_t>(v) > 0 ? 1u : 0u) << (c % 32);
        win[i][c / 32] |= (static_cast<int8_t>(v) != 0 ? 1u : 0u) << (c % 32);
      }
      bool full = h < HEIGHT;
#pragma unroll
      for (int k = 0; k < NWF; ++k) full &= pos[k] == features::full_row_word<WIDTH>(k);
      if (full) filled |= FillMask{1} << h;
    }
#pragma unroll
    for (int h = 0; h < HEIGHT; ++h)
      if (h < yc || h >= yc + S) filled |= static_cast<FillMask>(row_full(rows[h]) ? 1u : 0u) << h;
    int n;
    if constexpr (sizeof(FillMask) == 4) n = __popc(filled);
    else n = __popcll(static_cast<unsigned long long>(filled));
    const int status = frame_hit ? kIllegal : (stack_hit ? kOver : kPlaced);
    const long long ab = static_cast<long long>(b) * A + a;
    mask[ab] = frame_hit ? 0.0f : 1.0f;
    game_over[ab] = status == kOver ? 1 : 0;
    lines_out[ab] = status == kPlaced ? n : 0;

    if (mode == kFeatures) {
      Acc acc;
      acc.init();
      if (status == kIllegal) {
        for (int d = 0; d < HEIGHT; ++d) acc.add_full_row();
      } else if (status == kPlaced) {
        // the rows that stay, top-down (the cleared rows above them are
        // zeros): a window row's mask, or the staged row's filled cells
        const uint32_t* nz = snz + e * H * NW;
#pragma unroll
        for (int h = 0; h < HEIGHT; ++h) {
          if ((filled >> h) & 1u) continue;
          const int i = h - yc;
          uint32_t m[NWF] = {};
          if (i >= 0 && i < S) {
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int k = 0; k < NWF; ++k) m[k] = s == i ? win[s][k] : m[k];
          } else {
            uint32_t row[NW];
#pragma unroll
            for (int j = 0; j < NW; ++j) row[j] = nz[h * NW + j];
            features::crop_row<NW, PAD, WIDTH>(row, m);
          }
          acc.add_row(m);
        }
      }
      if constexpr (kStageFeatures) acc.write(flags, sfeat + t * n_feat);
      else acc.write(flags, static_cast<float*>(obs) + ab * n_feat);
    } else {
      int8_t* src = ssrc + t * HEIGHT;
      for (int d = 0; d < HEIGHT; ++d) src[d] = -1;
      int cum = 0;  // full rows at or above h
      for (int h = 0; h < HEIGHT; ++h) {
        const int f = static_cast<int>((filled >> h) & 1u);
        cum += f;
        if (!f) src[h + n - cum] = static_cast<int8_t>(h);
      }
      sstatus[t] = status;
#pragma unroll
      for (int k = 0; k < TW; ++k) sword[t * TW + k] = pword.w[k];
      sxc[t] = xc;
      syc[t] = yc;
      spid[t] = pid;
    }
  }
  __syncthreads();

  // -- the block's candidates are contiguous in obs: write them together
  const int n_cand = n_env * A;
  const long long first = static_cast<long long>(b0) * A;
  if (mode == kFeatures) {
    if constexpr (kStageFeatures) {
      float* out = static_cast<float*>(obs) + first * n_feat;
      for (int i = threadIdx.x; i < n_cand * n_feat; i += blockDim.x) out[i] = sfeat[i];
    }
    return;
  }
  auto cell = [&](int i) -> int8_t {  // cell i of the block's boards
    const int c = i / BOARD, rem = i % BOARD;
    const int r = rem / PW, col = rem % PW;
    if (sstatus[c] == kIllegal) return 1;
    if (sstatus[c] == kOver) return 0;
    const int src = r < HEIGHT ? ssrc[c * HEIGHT + r] : HEIGHT;
    PieceWord w;
#pragma unroll
    for (int k = 0; k < TW; ++k) w.w[k] = sword[c * TW + k];
    return cleared_cell(sboard + (c / A) * BOARD, src, col, w, sxc[c], syc[c], spid[c]);
  };
  // A is a multiple of 4, so a block's first board and its count of cells
  // are too: 16-byte stores of 4 floats, 4-byte stores of 4 ids
  if (mode == kBoards) {
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(obs) + first * BOARD);
    for (int i = threadIdx.x; i < n_cand * BOARD / 4; i += blockDim.x)
      out[i] = make_float4(cell(4 * i), cell(4 * i + 1), cell(4 * i + 2), cell(4 * i + 3));
  } else {
    uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<int8_t*>(obs) + first * BOARD);
    for (int i = threadIdx.x; i < n_cand * BOARD / 4; i += blockDim.x) {
      uint32_t w = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) w |= static_cast<uint32_t>(static_cast<uint8_t>(cell(4 * i + k))) << (8 * k);
      out[i] = w;
    }
  }
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
  const int blocks = (B + kEnvs - 1) / kEnvs;
  grouped_flagship_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(boards), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(box), static_cast<const int32_t*>(ids), obs,
      static_cast<float*>(mask), static_cast<uint8_t*>(game_over), static_cast<int32_t*>(lines), B,
      mode, flags);
  return static_cast<int>(cudaGetLastError());
}
