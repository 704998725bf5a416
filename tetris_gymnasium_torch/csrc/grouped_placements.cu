// Placement enumeration of the turbo grouped engine for Hopper (sm_90a):
// one thread per (env, candidate).
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
// and unpacked.  Here a block stages the packed rows of its envs in shared
// memory once (each row is read by the A threads of its env); each thread
// copies its env's rows into registers and runs the turbo engine's bit
// helpers on them (engine_common.cuh: hit_map over rows[H][NW], project,
// row_full), keeping nothing of its candidate board but the mask of full
// rows:
//   - the compaction keeps the order of the rows that stay and packs them to
//     the bottom (a row moves down by the full rows below it), so the
//     non-empty rows of the cleared board come out top-down in one pass with
//     no gaps and no scratch board;
//   - column heights come from the bit-sliced counters of features.cuh over
//     the rows' playfield bits; holes are the sum of the heights less the
//     occupied cells;
//   - each thread leaves its observation in shared memory (WIDTH + 3
//     floats, or HEIGHT cropped row masks for a board) and the block then
//     writes its candidates' observations, which are contiguous in obs,
//     together: consecutive threads store consecutive words (16-byte stores
//     for boards), where one thread writing its own board would leave every
//     store of a warp a board from the next.  Where a mode's staging area
//     does not fit in 227 KB (features from width 116, boards at the
//     tallest and widest boards) each thread stores its own.
//
// The geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:engine_defines, one library per geometry), as for
// turbo_step.cu: padded height <= 64, padded width <= 128, piece side <= 8,
// 1-32 pieces; rows of NW words, piece entries of TW words, hit maps and
// full-row masks of 64 bits past 32 rows.  With NW == TW == 1 every helper
// is the single-word code.  Envs a block: as many as 256 threads take
// (6 at 10x20, 2 at 30x20, 1 from width 33), fewer where their shared
// memory would pass 48 KB; a single env past 48 KB opts in to more.
//
// Bound on this card: operations in features mode, bytes in boards mode.  A
// candidate costs ~(H - S + 1) * 2 S NW integer operations for the hit map,
// ~2 HEIGHT NW for the full-row mask and ~(2 + 3 kPlanes) HEIGHT NWF for
// the compaction and counters, and writes 4 (WIDTH + 3) + 9 bytes
// (features) or 4 HEIGHT WIDTH + 9 (boards).

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"
#include "features.cuh"

using namespace engine;

struct PlacementParams {
  int max_clear;  // compaction envelope
  int mode;       // 0 features, 1 boards
};

namespace {

constexpr int A = WIDTH * 4;                  // candidates an env
using Acc = features::Acc<HEIGHT, WIDTH>;
constexpr int NWF = Acc::NWF;                 // words of a cropped row
constexpr int kFeat = WIDTH + 3;              // floats of a features slot
constexpr int kBoardSlot = HEIGHT * NWF;      // words of a boards slot
constexpr int kMaxThreads = A > 256 ? A : 256;
constexpr size_t kDefaultSmem = 48 * 1024;    // without opting in to more
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kRowBytes = 4 * H * NW;      // an env's staged rows
constexpr bool kStageFeatures = kRowBytes + 4 * size_t{A} * kFeat <= kMaxSmem;
constexpr bool kStageBoards = kRowBytes + 4 * size_t{A} * kBoardSlot <= kMaxSmem;

// One candidate: drop, legality, lock, clear; writes its mask, game-over and
// lines, and its observation into its staging slot `stage` or, where the
// mode is not staged, straight into `obs`.
__device__ __forceinline__ void evaluate_candidate(
    const uint32_t* r, int E, int p, int rotation, int a, int b, int B,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box, uint32_t* stage,
    float* __restrict__ obs, float* __restrict__ mask, uint8_t* __restrict__ game_over,
    int32_t* __restrict__ lines_out, const PlacementParams& prm) {
  Rows rows;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) rows[h][j] = r[(h * NW + j) * E];

  // -- candidate geometry (_candidate_geometry :93)
  int rot = (rotation + (a & 3)) % 4;
  if (rot < 0) rot += 4;
  const int x = a / 4 + PAD - piece_entry(box, p) / 2;
  const PieceWord w = piece_word(packed, p, rot);  // 0 outside the table, as turbo looks up

  // -- drop from the top; legality against the bedrock frame, game over
  //    against the stack
  const HitMask hm = hit_map(rows, w, x);
  const int y = drop_from_map(hm, 0);
  const int yc = clamp_start(y, H - S, H);
  uint32_t sp[S][NW];
  shifted_piece(w, x, sp);
  bool frame_hit = false;
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      frame_hit |= ((yc + k < HEIGHT ? side_word(j) : full_word(j)) & sp[k][j]) != 0u;
  bool stack_hit = collision_at(hm, y) && !frame_hit;

  // -- lock and find the full rows
  project(rows, w, x, y);
  FillMask filled = filled_mask(rows);
  int n;
  if constexpr (sizeof(FillMask) == 4) n = __popc(filled);
  else n = __popcll(static_cast<unsigned long long>(filled));
  stack_hit |= n > prm.max_clear;

  const long long ab = static_cast<long long>(a) * B + b;
  mask[ab] = frame_hit ? 0.0f : 1.0f;
  game_over[ab] = stack_hit ? 1 : 0;
  lines_out[ab] = (frame_hit || stack_hit) ? 0 : n;
  const long long cand = static_cast<long long>(b) * A + a;  // its place in obs

  // the rows of the cleared board that are not empty, top-down: every row
  // that stays and moves by at most max_clear, in order, to row d
  auto for_kept_rows = [&](auto put) {
    int cum = 0;  // full rows at or above h
#pragma unroll
    for (int h = 0; h < HEIGHT; ++h) {
      const int f = static_cast<int>((filled >> h) & 1u);
      cum += f;
      if (f || n - cum > prm.max_clear) continue;
      uint32_t m[NWF];
      features::crop_row<NW, PAD, WIDTH>(rows[h], m);
      put(h + n - cum, m);
    }
  };

  if (prm.mode == 0) {
    Acc acc;
    acc.init();
    if (!stack_hit) {
      if (frame_hit) {
        for (int d = 0; d < HEIGHT; ++d) acc.add_full_row();
      } else {
        for_kept_rows([&](int, const uint32_t(&m)[NWF]) { acc.add_row(m); });
      }
    }
    if constexpr (kStageFeatures) acc.write(features::kAll, reinterpret_cast<float*>(stage));
    else acc.write(features::kAll, obs + cand * kFeat);
    return;
  }

  // boards: the cleared playfield rows, top-down
  auto put_row = [&](int d, const uint32_t (&m)[NWF]) {
    if constexpr (kStageBoards) {
#pragma unroll
      for (int k = 0; k < NWF; ++k) stage[d * NWF + k] = m[k];
    } else {
      float* o = obs + (cand * HEIGHT + d) * WIDTH;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) o[c] = static_cast<float>((m[c / 32] >> (c % 32)) & 1u);
    }
  };
  uint32_t none[NWF], all[NWF];
#pragma unroll
  for (int k = 0; k < NWF; ++k) {
    none[k] = 0u;
    all[k] = features::full_row_word<WIDTH>(k);
  }
  if (stack_hit || frame_hit) {
    for (int d = 0; d < HEIGHT; ++d) {
      if (stack_hit) put_row(d, none);
      else put_row(d, all);
    }
    return;
  }
  int next = 0;  // next output row to write
  for_kept_rows([&](int d, const uint32_t (&m)[NWF]) {
    for (; next < d; ++next) put_row(next, none);
    put_row(d, m);
    next = d + 1;
  });
  for (; next < HEIGHT; ++next) put_row(next, none);
}

__global__ void __launch_bounds__(kMaxThreads) grouped_placements_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ box, float* __restrict__ obs, float* __restrict__ mask,
    uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out, int B, PlacementParams prm) {
  // shared: the envs' packed rows [H][NW][E], then one staging slot per
  // candidate (features: WIDTH + 3 floats; boards: HEIGHT cropped rows)
  extern __shared__ uint32_t smem[];
  const int E = blockDim.x / A;  // envs per block
  const int b0 = blockIdx.x * E;
  const bool staged_mode = prm.mode == 0 ? kStageFeatures : kStageBoards;
  const int slot = staged_mode ? (prm.mode == 0 ? kFeat : kBoardSlot) : 0;
  uint32_t* staged = smem;
  uint32_t* stage = smem + E * H * NW;
  for (int i = threadIdx.x; i < E * H * NW; i += blockDim.x) {
    const int hw = i / E, e = i % E;
    staged[i] = b0 + e < B ? rows[static_cast<long long>(hw) * B + b0 + e] : 0u;
  }
  __syncthreads();
  const int e = threadIdx.x / A;
  const int a = threadIdx.x % A;
  const int b = b0 + e;
  if (b < B)
    evaluate_candidate(staged + e, E, piece[b], rotation[b], a, b, B, packed, box,
                       stage + threadIdx.x * slot, obs, mask, game_over, lines_out, prm);
  if (!staged_mode) return;
  __syncthreads();

  // The block's candidates are contiguous in obs: write them together, so
  // that consecutive threads store consecutive words.
  const int n_cand = min(E, B - b0) * A;
  const long long first = static_cast<long long>(b0) * A;
  if (prm.mode == 0) {
    float* out = obs + first * kFeat;
    const float* src = reinterpret_cast<const float*>(stage);
    for (int i = threadIdx.x; i < n_cand * kFeat; i += blockDim.x) out[i] = src[i];
    return;
  }
  constexpr int cells = HEIGHT * WIDTH;
  auto cell = [&](int i) -> float {  // float i of the block's boards
    const int c = i / cells, rem = i % cells;
    const int col = rem % WIDTH;
    const uint32_t word = stage[(c * HEIGHT + rem / WIDTH) * NWF + col / 32];
    return static_cast<float>((word >> (col % 32)) & 1u);
  };
  // A is a multiple of 4, so a block's first board and its count of cells
  // are too: 16-byte stores of 4 floats
  float4* out4 = reinterpret_cast<float4*>(obs + first * cells);
  for (int i = threadIdx.x; i < n_cand * cells / 4; i += blockDim.x)
    out4[i] = make_float4(cell(4 * i), cell(4 * i + 1), cell(4 * i + 2), cell(4 * i + 3));
}

}  // namespace

// rows: uint32[H, B] (one word a row) or uint32[H, NW, B]; piece, rotation:
// int32[B]; packed: uint32[NP * 4 * TW]; box: int32[NP]; obs: float32[B, A,
// WIDTH + 3] or [B, A, HEIGHT, WIDTH]; mask: float32[A, B]; game_over:
// bool[A, B]; lines: int32[A, B].
extern "C" int grouped_placements_launch(const void* rows, const void* piece,
                                         const void* rotation, const void* packed,
                                         const void* box, void* obs, void* mask,
                                         void* game_over, void* lines, int B,
                                         const PlacementParams* params, void* stream) {
  const PlacementParams prm = *params;
  const bool staged_mode = prm.mode == 0 ? kStageFeatures : kStageBoards;
  const size_t slot = staged_mode ? (prm.mode == 0 ? kFeat : kBoardSlot) : 0;
  const size_t per_env = kRowBytes + 4 * A * slot;
  const int envs_per_block =
      max(1, min(kMaxThreads / A, static_cast<int>(kDefaultSmem / per_env)));
  const int threads = envs_per_block * A;
  const int blocks = (B + envs_per_block - 1) / envs_per_block;
  const size_t smem = envs_per_block * per_env;
  static size_t opted = kDefaultSmem;  // the most dynamic shared memory opted in to so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_placements_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  grouped_placements_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(box), static_cast<float*>(obs), static_cast<float*>(mask),
      static_cast<uint8_t*>(game_over), static_cast<int32_t*>(lines), B, prm);
  return static_cast<int>(cudaGetLastError());
}
