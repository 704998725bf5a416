// Turbo engine step and reset for Hopper (sm_90a): one thread per env.
//
// Replaces the JAX turbo step, tetris_gymnasium_tpu/core/turbo.py:step (:639)
// with _apply_action (:545), _swap (:507), _commit (:580), _clear_lines (:364)
// and _init_from_key (:440), plus the counter RNG (ops/rng.py:48-114) and the
// 7-bag draw (components/tetromino_randomizer.py:bag_draw :35) inside it.
// The plain PyTorch twin is tetris_gymnasium_torch/core/turbo.py:step_plain;
// every output is bit-equal to it.
//
// On the TPU the step is branch-free vector code over [H, B] tiles, with
// one-hot selects standing in for per-env control flow.  Here each thread
// owns one env and branches: the env's H x NW row words, bag, queue and
// holder live in registers (every array index below is a compile-time
// constant after unrolling), the hit map of a piece over all window starts
// is one 32- or 64-bit mask, and the key advances only where a draw
// happens.  State arrays are batch-minor ([rows, B], [H, NW, B] for the
// rows), so every load and store of a field is coalesced along B.
//
// Bound on this card: bytes.  One env-step reads the state (H * NW row
// words + 2 key words + NP bag + QS queue + 2 * HS holder words + 9 scalar
// words, and 2 bools; at the default 10x20 board 24 rows, 194 bytes) and
// the action, and writes the state plus reward, done and lines: 401 bytes
// in all at 10x20, 0.120 ns per env-step at 3.35 TB/s; 593 bytes at 30x20
// (NW = 2) and 61x12 (NW = 3, 16 rows).  The integer work (a few hundred
// instructions per env, times NW in the hit maps and the line clear) stays
// under that at full occupancy; the design keeps to one pass over the state
// and no scratch traffic.  At NW > 1 the 48 row words of 30x20 or 61x12 sit
// in registers beside the rest of the env; nvcc's -Xptxas -v report
// (kernels.build) gives the registers and any spill of each geometry.
//
// Geometry is fixed at compile time by the TETRIS_* defines
// (engine_common.cuh, kernels.py:engine_defines), one library per geometry.
// The state may be stepped in place (each thread reads all of its env
// before it writes) but the wrapper writes to new buffers.  The RNG, the
// draws, the swap and the bit helpers are shared with the flagship engine's
// kernels (engine_common.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"

using namespace engine;

// Pointers to the 17 batch-minor fields of a TurboState, in field order.
struct StatePtrs {
  uint32_t* key;           // [2, B]
  uint32_t* rows;          // [H, NW, B]
  int32_t* piece;          // [B]
  int32_t* rotation;       // [B]
  int32_t* x;              // [B]
  int32_t* y;              // [B]
  int32_t* bag;            // [NP, B]
  int32_t* bag_index;      // [B]
  int32_t* queue;          // [QS, B]
  int32_t* holder_piece;   // [HS, B]
  int32_t* holder_rotation;// [HS, B]
  int32_t* holder_count;   // [B]
  uint8_t* has_swapped;    // [B] (torch.bool)
  uint8_t* game_over;      // [B] (torch.bool)
  float* score;            // [B]
  int32_t* lines;          // [B]
  int32_t* steps;          // [B]
};

struct StepParams {
  int gravity;      // EngineConfig.gravity_enabled
  int auto_reset;   // EngineConfig.auto_reset
  int uniform;      // queue_kind == "uniform" (else "bag")
  int max_clear;    // compaction envelope
  float r_alife;    // RewardsMapping.alife as float32
  float r_game_over;// RewardsMapping.game_over as float32
};

namespace {
__device__ __forceinline__ void load_env(Env& e, const StatePtrs& p, int b, int B) {
  e.k0 = p.key[b];
  e.k1 = p.key[B + b];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) e.rows[h][j] = p.rows[(h * NW + j) * B + b];
  e.piece = p.piece[b];
  e.rotation = p.rotation[b];
  e.x = p.x[b];
  e.y = p.y[b];
#pragma unroll
  for (int i = 0; i < NP; ++i) e.bag[i] = p.bag[i * B + b];
  e.bag_index = p.bag_index[b];
#pragma unroll
  for (int i = 0; i < QS; ++i) e.queue[i] = p.queue[i * B + b];
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    e.holder_piece[i] = p.holder_piece[i * B + b];
    e.holder_rotation[i] = p.holder_rotation[i * B + b];
  }
  e.holder_count = p.holder_count[b];
  e.has_swapped = p.has_swapped[b] != 0;
  e.game_over = p.game_over[b] != 0;
  e.score = p.score[b];
  e.lines = p.lines[b];
  e.steps = p.steps[b];
}

__device__ __forceinline__ void store_env(const Env& e, const StatePtrs& p, int b, int B) {
  p.key[b] = e.k0;
  p.key[B + b] = e.k1;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) p.rows[(h * NW + j) * B + b] = e.rows[h][j];
  p.piece[b] = e.piece;
  p.rotation[b] = e.rotation;
  p.x[b] = e.x;
  p.y[b] = e.y;
#pragma unroll
  for (int i = 0; i < NP; ++i) p.bag[i * B + b] = e.bag[i];
  p.bag_index[b] = e.bag_index;
#pragma unroll
  for (int i = 0; i < QS; ++i) p.queue[i * B + b] = e.queue[i];
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    p.holder_piece[i * B + b] = e.holder_piece[i];
    p.holder_rotation[i * B + b] = e.holder_rotation[i];
  }
  p.holder_count[b] = e.holder_count;
  p.has_swapped[b] = e.has_swapped ? 1 : 0;
  p.game_over[b] = e.game_over ? 1 : 0;
  p.score[b] = e.score;
  p.lines[b] = e.lines;
  p.steps[b] = e.steps;
}

__global__ void __launch_bounds__(128) turbo_step_kernel(
    StatePtrs in, StatePtrs out, const int32_t* __restrict__ action, float* __restrict__ reward_out,
    uint8_t* __restrict__ done_out, int32_t* __restrict__ lines_out,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box, int B, StepParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const bool uniform = p.uniform != 0;
  Env e;
  load_env(e, in, b, B);
  float reward = 0.0f;
  int lines = 0;

  if (!e.game_over) {  // a finished game freezes, key and steps included
    const int a = action[b];
    // -- phase 1: the action's direct effect, tested against the pre-step rows
    apply_action<false>(e, a, uniform, packed, box);
    // -- phase 2: gravity, then commit on rest or hard drop
    const PieceWord w1 = piece_word(packed, e.piece, e.rotation);
    const HitMask hm1 = hit_map(e.rows, w1, e.x);
    const bool is_drop = a == kDrop;
    const bool grav_free = !collision_at(hm1, e.y + 1);
    const bool fall = p.gravity ? (!is_drop && grav_free) : false;
    const bool commit_now = p.gravity ? (is_drop || !grav_free) : is_drop;
    e.y += fall ? 1 : 0;
    if (commit_now) {
      if (collision_at(hm1, e.y)) {  // pre_over: nothing else changes
        e.game_over = true;
        reward = p.r_game_over;
      } else {
        project(e.rows, w1, e.x, e.y + drop_from_map(hm1, e.y));
        const int n = clear_lines(e.rows, p.max_clear);
        const int new_piece = queue_draw(e, uniform);
        const int sx = spawn_x(box, new_piece);
        const bool spawn_over =
            spawn_overlap(e.rows, piece_word(packed, new_piece, 0), sx) || n > p.max_clear;
        reward = spawn_over ? p.r_game_over : static_cast<float>(n * n * WIDTH) + p.r_alife;
        e.piece = new_piece;
        e.rotation = 0;
        e.x = sx;
        e.y = 0;
        e.has_swapped = false;
        e.game_over = spawn_over;
        e.lines += n;
        lines = n;
      }
    }
    e.score = e.score + reward;
    e.steps += 1;
  }
  const bool done = e.game_over;
  if (p.auto_reset && done) init_env(e, e.k0, e.k1, uniform, box);
  store_env(e, out, b, B);
  reward_out[b] = reward;
  done_out[b] = done ? 1 : 0;
  lines_out[b] = lines;
}

__global__ void __launch_bounds__(128) turbo_init_kernel(
    const uint32_t* __restrict__ keys, StatePtrs out, const int32_t* __restrict__ box, int B,
    int uniform) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Env e;
  init_env(e, keys[2 * b], keys[2 * b + 1], uniform != 0, box);
  store_env(e, out, b, B);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int turbo_step_launch(const StatePtrs* in, const StatePtrs* out, const void* action,
                                 void* reward, void* done, void* lines, const void* packed,
                                 const void* box, int B, const StepParams* params, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  turbo_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *in, *out, static_cast<const int32_t*>(action), static_cast<float*>(reward),
      static_cast<uint8_t*>(done), static_cast<int32_t*>(lines),
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box), B, *params);
  return static_cast<int>(cudaGetLastError());
}

// keys: uint32[B, 2] (mesh.batch_keys layout).
extern "C" int turbo_init_launch(const void* keys, const StatePtrs* out, const void* box, int B,
                                 int uniform, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  turbo_init_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), *out, static_cast<const int32_t*>(box), B, uniform);
  return static_cast<int>(cudaGetLastError());
}
