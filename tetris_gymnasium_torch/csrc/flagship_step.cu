// Flagship engine step, reset and board observation for Hopper (sm_90a).
//
// Replaces the JAX flagship engine, tetris_gymnasium_tpu/core/engine.py:
// step (:451) with _apply_action (:412), _swap (:365) and _commit (:289)
// over the bit operations of ops/bitboard.py:58-230, init_state (:131) on
// its own and on auto-reset, and observe_board (:274).  The plain PyTorch
// twins are tetris_gymnasium_torch/core/engine.py:step_plain, init_plain and
// observe_board_plain; every output is bit-equal to them.
//
// On the TPU the step is one straight-line masked program per env under
// vmap, with every candidate outcome computed and selected.  Here one
// thread owns one env and branches.  The state is batch-leading: the id
// board int8[B, H, PW] (432 bytes an env at 10x20, 912 at 30x20) and small
// per-env fields.  A block of 32 envs first copies its 32 boards
// (contiguous in memory) into shared memory with 16-byte loads,
// neighbouring threads on neighbouring words; each thread then packs its
// board into H x NW occupancy words in registers and runs the turbo
// engine's bit logic on them (engine_common.cuh).  Only a lock writes the
// id board: the piece's id is ADDED into its S x S window (the JAX project
// adds), full rows go and the kept rows move down row by row in shared
// memory, the cleared rows at the top become zeros and the pad columns and
// bottom rows are rewritten as bedrock.  The block then stores its boards
// back with 16-byte stores.
//
// Bound on this card: bytes.  A step reads the board and ~80 bytes of
// other state and the action, and writes the same plus reward, done and
// lines: ~1.06 KB an env at 10x20 (0.16 us at B = 512, 21 us at B = 65536
// at 3.35 TB/s), ~2.03 KB at 30x20.  The integer work per env (a few
// hundred instructions, more on a lock) is below that at full occupancy.
// flagship_init writes a fresh state (~0.53 KB an env at 10x20);
// flagship_observe_board reads the board and writes the cropped
// int8[HEIGHT, WIDTH] frame (432 + 200 bytes an env at 10x20), 32 envs a
// block, one thread per (env, row), the frames staged in shared memory and
// stored in 16-byte words.
//
// Geometry is fixed at compile time by the TETRIS_* defines
// (engine_common.cuh, kernels.py:engine_defines), one library per
// geometry.  What other geometries change here:
//   - pack_rows builds each row word by word, bit w - 32 j of word j, so no
//     shift reaches 32 (the default build's 1u << w does not generalise);
//   - BOARD = H * PW need not be a multiple of 16 (648 bytes at 28x14, 924
//     for the 6x6 pieces at 30x16): 32 boards always are, so every block's
//     boards start on a 16-byte boundary, and block_copy16 moves the
//     bytes of a ragged tail one a thread;
//   - the boards of a block (and the observation's frames) live in dynamic
//     shared memory: 32 envs a block always, kEnvs * BOARD bytes for the
//     step and the init, kObsEnvs * (BOARD + OBS) for the observation (29 KB
//     and 48 KB at 30x20, 35 KB and 58 KB at 61x12), opted in above 48 KB;
//     engine_defines keeps BOARD <= 3072 so that the observation's 196 KB
//     stays inside the 227 KB a block may have.

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"

using namespace engine;

// Pointers to the 17 fields of a flagship EngineState, in field order.
struct FlagshipPtrs {
  uint32_t* key;            // [2, B] (the turbo state's layout)
  int8_t* board;            // [B, H, PW]
  int32_t* piece;           // [B]
  int32_t* rotation;        // [B]
  int32_t* x;               // [B]
  int32_t* y;               // [B]
  int32_t* bag;             // [B, NP]
  int32_t* bag_index;       // [B]
  int32_t* queue;           // [B, QS]
  int32_t* holder_piece;    // [B, HS]
  int32_t* holder_rotation; // [B, HS]
  int32_t* holder_count;    // [B]
  uint8_t* has_swapped;     // [B] (torch.bool)
  uint8_t* game_over;       // [B] (torch.bool)
  float* score;             // [B]
  int32_t* lines;           // [B]
  int32_t* steps;           // [B]
};

struct FlagshipParams {
  int gravity;       // EngineConfig.gravity_enabled
  int auto_reset;    // EngineConfig.auto_reset
  int uniform;       // queue_kind == "uniform" (else "bag")
  float r_alife;     // RewardsMapping.alife as float32
  float r_game_over; // RewardsMapping.game_over as float32
};

namespace {

constexpr int BOARD = H * PW;  // bytes of a board: 432 at 10x20
constexpr int kEnvs = 32;      // envs (threads) a block of the step and the init
constexpr int kObsEnvs = 32;   // envs a block of the observation
constexpr int kObsThreads = 256;
constexpr int OBS = HEIGHT * WIDTH;  // bytes of a cropped frame: 200 at 10x20
constexpr int kStepSmem = kEnvs * BOARD;
constexpr int kObsSmem = kObsEnvs * (BOARD + OBS);
static_assert((kEnvs * BOARD) % 16 == 0 && (kObsEnvs * BOARD) % 16 == 0 &&
              (kObsEnvs * OBS) % 16 == 0, "each block's boards and frames start 16-byte aligned");
static_assert(kObsSmem <= 227 * 1024 && kStepSmem <= 227 * 1024, "shared memory of a block");

__device__ __forceinline__ void load_env(Env& e, const FlagshipPtrs& p, int b, int B) {
  e.k0 = p.key[b];
  e.k1 = p.key[B + b];
  e.piece = p.piece[b];
  e.rotation = p.rotation[b];
  e.x = p.x[b];
  e.y = p.y[b];
#pragma unroll
  for (int i = 0; i < NP; ++i) e.bag[i] = p.bag[b * NP + i];
  e.bag_index = p.bag_index[b];
#pragma unroll
  for (int i = 0; i < QS; ++i) e.queue[i] = p.queue[b * QS + i];
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    e.holder_piece[i] = p.holder_piece[b * HS + i];
    e.holder_rotation[i] = p.holder_rotation[b * HS + i];
  }
  e.holder_count = p.holder_count[b];
  e.has_swapped = p.has_swapped[b] != 0;
  e.game_over = p.game_over[b] != 0;
  e.score = p.score[b];
  e.lines = p.lines[b];
  e.steps = p.steps[b];
}

// Every field but the board, which the block stores from shared memory.
__device__ __forceinline__ void store_env(const Env& e, const FlagshipPtrs& p, int b, int B) {
  p.key[b] = e.k0;
  p.key[B + b] = e.k1;
  p.piece[b] = e.piece;
  p.rotation[b] = e.rotation;
  p.x[b] = e.x;
  p.y[b] = e.y;
#pragma unroll
  for (int i = 0; i < NP; ++i) p.bag[b * NP + i] = e.bag[i];
  p.bag_index[b] = e.bag_index;
#pragma unroll
  for (int i = 0; i < QS; ++i) p.queue[b * QS + i] = e.queue[i];
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    p.holder_piece[b * HS + i] = e.holder_piece[i];
    p.holder_rotation[b * HS + i] = e.holder_rotation[i];
  }
  p.holder_count[b] = e.holder_count;
  p.has_swapped[b] = e.has_swapped ? 1 : 0;
  p.game_over[b] = e.game_over ? 1 : 0;
  p.score[b] = e.score;
  p.lines[b] = e.lines;
  p.steps[b] = e.steps;
}

// pack_board: bit w % 32 of word w / 32 of row h is set iff the cell id is
// > 0 (signed).
__device__ __forceinline__ void pack_rows(Env& e, const int8_t* bd) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t r = 0;
#pragma unroll
      for (int w = 32 * j; w < PW && w < 32 * j + 32; ++w)
        r |= (bd[h * PW + w] > 0 ? 1u : 0u) << (w - 32 * j);
      e.rows[h][j] = r;
    }
  }
}

// create_board: zeros inside, bedrock on the left, right and bottom.
__device__ __forceinline__ void empty_board(int8_t* bd) {
  for (int h = 0; h < H; ++h)
    for (int w = 0; w < PW; ++w)
      bd[h * PW + w] = (h >= HEIGHT || w < PAD || w >= PAD + WIDTH) ? 1 : 0;
}

// ops/board.py:project with the piece's id: ADD it into the clamped window
// (int8 wrap, as the JAX sum in int8).
__device__ __forceinline__ void stamp_ids(int8_t* bd, const PieceWord& word, int x, int y, int id) {
  const int xc = clamp_start(x, PW - S, PW);
  const int yc = clamp_start(y, H - S, H);
  for (int i = 0; i < S; ++i) {
    const uint32_t row = piece_row(word, i);
    for (int j = 0; j < S; ++j) {
      if ((row >> j) & 1u) {
        int8_t& c = bd[(yc + i) * PW + xc + j];
        c = static_cast<int8_t>(c + id);
      }
    }
  }
}

// compact_ids and the re-pad of _commit: kept playfield rows move down past
// the full rows below them (bottom-up, so each source row is read before it
// is overwritten), the top rows become zeros, the pad columns and the
// bottom rows bedrock.
__device__ __forceinline__ void compact_ids(int8_t* bd, FillMask filled) {
  int s = HEIGHT - 1;
  for (int d = HEIGHT - 1; d >= 0; --d) {
    while (s >= 0 && ((filled >> s) & 1u)) --s;
    int8_t* dst = bd + d * PW;
    if (s >= 0) {
      if (s != d)
        for (int w = PAD; w < PAD + WIDTH; ++w) dst[w] = bd[s * PW + w];
      --s;
    } else {
      for (int w = PAD; w < PAD + WIDTH; ++w) dst[w] = 0;
    }
    for (int w = 0; w < PAD; ++w) {
      dst[w] = 1;
      dst[PAD + WIDTH + w] = 1;
    }
  }
  for (int i = HEIGHT * PW; i < BOARD; ++i) bd[i] = 1;
}

__global__ void __launch_bounds__(kEnvs) flagship_step_kernel(
    FlagshipPtrs in, FlagshipPtrs out, const int32_t* __restrict__ action,
    float* __restrict__ reward_out, uint8_t* __restrict__ done_out, int32_t* __restrict__ lines_out,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box,
    const int32_t* __restrict__ ids, int B, FlagshipParams p) {
  extern __shared__ __align__(16) int8_t boards[];  // kStepSmem bytes
  const int base = blockIdx.x * kEnvs;
  const int n = min(kEnvs, B - base);
  block_copy16(boards, in.board + static_cast<size_t>(base) * BOARD, n * BOARD);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < n) {
    const int b = base + t;
    const bool uniform = p.uniform != 0;
    int8_t* bd = boards + t * BOARD;
    Env e;
    load_env(e, in, b, B);
    pack_rows(e, bd);
    float reward = 0.0f;
    int lines = 0;

    if (!e.game_over) {  // a finished game freezes: the input state, reward 0
      const int a = action[b];
      // -- phase 1: the action's direct effect, tested against the pre-step rows
      apply_action<true>(e, a, uniform, packed, box);
      // -- phase 2: gravity, then commit on rest or hard drop
      const PieceWord w1 = piece_word_2d(packed, e.piece, e.rotation);
      const HitMask hm1 = hit_map(e.rows, w1, e.x);
      const bool is_drop = a == kDrop;
      const bool grav_free = !collision_at(hm1, e.y + 1);
      const bool fall = p.gravity ? (!is_drop && grav_free) : false;
      const bool commit_now = p.gravity ? (is_drop || !grav_free) : is_drop;
      e.y += fall ? 1 : 0;
      if (commit_now) {
        if (collision_at(hm1, e.y)) {  // pre_over: only game_over changes
          e.game_over = true;
          reward = p.r_game_over;
        } else {
          const int y_f = e.y + drop_from_map(hm1, e.y);
          stamp_ids(bd, w1, e.x, y_f, piece_entry(ids, e.piece));
          project(e.rows, w1, e.x, y_f);
          const FillMask filled = filled_mask(e.rows);
          const int nl = clear_lines(e.rows, HEIGHT);  // no envelope: any number of rows
          compact_ids(bd, filled);
          const int new_piece = queue_draw(e, uniform);
          const int sx = spawn_x(box, new_piece);
          const bool spawn_over = spawn_overlap(e.rows, piece_word_2d(packed, new_piece, 0), sx);
          reward = spawn_over ? p.r_game_over : static_cast<float>(nl * nl * WIDTH) + p.r_alife;
          e.piece = new_piece;
          e.rotation = 0;
          e.x = sx;
          e.y = 0;
          e.has_swapped = false;
          e.game_over = spawn_over;
          e.lines += nl;
          lines = nl;
        }
      }
      e.score = e.score + reward;
      e.steps += 1;
    }
    const bool done = e.game_over;
    if (p.auto_reset && done) {  // the counter key keeps streaming
      init_env(e, e.k0, e.k1, uniform, box);
      empty_board(bd);
    }
    store_env(e, out, b, B);
    reward_out[b] = reward;
    done_out[b] = done ? 1 : 0;
    lines_out[b] = lines;
  }
  __syncthreads();
  block_copy16(out.board + static_cast<size_t>(base) * BOARD, boards, n * BOARD);
}

__global__ void __launch_bounds__(kEnvs) flagship_init_kernel(
    const uint32_t* __restrict__ keys, FlagshipPtrs out, const int32_t* __restrict__ box, int B,
    int uniform) {
  extern __shared__ __align__(16) int8_t boards[];  // kStepSmem bytes
  const int base = blockIdx.x * kEnvs;
  const int n = min(kEnvs, B - base);
  const int t = threadIdx.x;
  if (t < n) {
    const int b = base + t;
    Env e;
    init_env(e, keys[2 * b], keys[2 * b + 1], uniform != 0, box);
    empty_board(boards + t * BOARD);
    store_env(e, out, b, B);
  }
  __syncthreads();
  block_copy16(out.board + static_cast<size_t>(base) * BOARD, boards, n * BOARD);
}

// observe_board: occupancy 0/1 with the active piece ADDED as -1 unless the
// game is over, cropped to the playfield.
__global__ void __launch_bounds__(kObsThreads) flagship_observe_board_kernel(
    const int8_t* __restrict__ board, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const int32_t* __restrict__ xs,
    const int32_t* __restrict__ ys, const uint8_t* __restrict__ game_over,
    const uint32_t* __restrict__ packed, int8_t* __restrict__ out, int B) {
  extern __shared__ __align__(16) int8_t in_s[];  // kObsSmem bytes: the boards, then the frames
  int8_t* out_s = in_s + kObsEnvs * BOARD;
  const int base = blockIdx.x * kObsEnvs;
  const int n = min(kObsEnvs, B - base);
  block_copy16(in_s, board + static_cast<size_t>(base) * BOARD, n * BOARD);
  __syncthreads();
  for (int item = threadIdx.x; item < n * HEIGHT; item += blockDim.x) {
    const int t = item / HEIGHT;
    const int r = item % HEIGHT;
    const int b = base + t;
    const PieceWord word = game_over[b] ? no_piece() : piece_word_2d(packed, piece[b], rotation[b]);
    const int xc = clamp_start(xs[b], PW - S, PW);
    const int off = r - clamp_start(ys[b], H - S, H);
    uint32_t prow[NW];
    shift_row((off >= 0 && off < S) ? piece_row(word, off) : 0u, xc, prow);
    const int8_t* src = in_s + t * BOARD + r * PW;
    int8_t* dst = out_s + t * OBS + r * WIDTH;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const int col = c + PAD;
      dst[c] = static_cast<int8_t>((src[col] > 0 ? 1 : 0) -
                                   static_cast<int>((prow[col >> 5] >> (col & 31)) & 1u));
    }
  }
  __syncthreads();
  block_copy16(out + static_cast<size_t>(base) * OBS, out_s, n * OBS);
}

// Opts a kernel in to more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  done = true;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int flagship_step_launch(const FlagshipPtrs* in, const FlagshipPtrs* out,
                                    const void* action, void* reward, void* done, void* lines,
                                    const void* packed, const void* box, const void* ids, int B,
                                    const FlagshipParams* params, void* stream) {
  static bool opted = false;
  if (const cudaError_t err = allow_smem(flagship_step_kernel, kStepSmem, opted)) return err;
  const int blocks = (B + kEnvs - 1) / kEnvs;
  flagship_step_kernel<<<blocks, kEnvs, kStepSmem, static_cast<cudaStream_t>(stream)>>>(
      *in, *out, static_cast<const int32_t*>(action), static_cast<float*>(reward),
      static_cast<uint8_t*>(done), static_cast<int32_t*>(lines),
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box),
      static_cast<const int32_t*>(ids), B, *params);
  return static_cast<int>(cudaGetLastError());
}

// keys: uint32[B, 2] (mesh.batch_keys layout).
extern "C" int flagship_init_launch(const void* keys, const FlagshipPtrs* out, const void* box,
                                    int B, int uniform, void* stream) {
  static bool opted = false;
  if (const cudaError_t err = allow_smem(flagship_init_kernel, kStepSmem, opted)) return err;
  const int blocks = (B + kEnvs - 1) / kEnvs;
  flagship_init_kernel<<<blocks, kEnvs, kStepSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), *out, static_cast<const int32_t*>(box), B, uniform);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flagship_observe_board_launch(const void* board, const void* piece,
                                             const void* rotation, const void* x, const void* y,
                                             const void* game_over, const void* packed, void* out,
                                             int B, void* stream) {
  static bool opted = false;
  if (const cudaError_t err = allow_smem(flagship_observe_board_kernel, kObsSmem, opted)) return err;
  const int blocks = (B + kObsEnvs - 1) / kObsEnvs;
  flagship_observe_board_kernel<<<blocks, kObsThreads, kObsSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const int32_t*>(x),
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(game_over),
      static_cast<const uint32_t*>(packed), static_cast<int8_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}
