// Compat functional engine reset, step and observation for Hopper (sm_90a).
//
// Replaces tetris_gymnasium_tpu/core/fn_env.py: reset (:210) with the
// queues' create_bag (:41) / create_uniform (:76) and bag_next (:50), step
// (:189) with _update (:124) and _lock_piece (:80) over ops/board.py's
// collision (:60), project (:78), drop_distance (:116), gravity_step (:259),
// clear_lines_compat (:203) and score_fn (:242), and observe (:64).  The
// plain PyTorch twins are tetris_gymnasium_torch/core/fn_env.py:reset_plain,
// step_plain and observe_plain; every output is bit-equal to them.
//
// On the TPU the step is one straight-line masked program per env under
// vmap: every window is a one-hot contraction, every branch is computed and
// selected.  Here one thread owns one env and branches, reading only the
// S x S windows that a test needs.  The state is batch-leading: the id
// board int8[B, H, PW] (432 bytes an env at 10x20) and small per-env
// fields, the key uint32[B, 2].  A block of 256 threads takes kEnvs envs
// (64 at 10x20): it copies their boards (contiguous in memory) into shared
// memory with 16-byte loads, thread e plays env e on its board there, and
// the block stores the boards back with 16-byte stores; the observation
// int8[B, HEIGHT, WIDTH] is then written in 4-byte words, neighbouring
// threads on neighbouring words, from the boards in shared memory and each
// env's active window.
//
// What the reference's quirks ask of the code:
//   - every window start is clamped as lax.dynamic_slice clamps it (a
//     negative start wraps by +dim, then clips to [0, dim - S]), except the
//     rows of drop_distance, which clip without the wrap; the drop counts
//     the leading free window offsets and stops at H;
//   - a lock ADDS the piece's id into its window (project adds), then the
//     compat line clear keeps the unfilled rows in order at the bottom and
//     fills the n top rows with copies of the pre-clear row 0 (row 0 is
//     never written while the rows move down, so it is read in place), and
//     rewrites the pad columns and bottom rows as bedrock;
//   - the queue draws from the state's key and its key is thrown away: the
//     next key is split(key)[0]; only a refill (queue_index >= QS) draws
//     split(key)[1] into a fresh queue, a stable sort of QS 32-bit keys (the
//     one round of jax.random.permutation below 1626 items) or QS randint
//     draws below QS - 1 (the uniform queue's off-by-one);
//   - the score is float32, (score + move_reward) + lock_reward, and the
//     reward is new score - old score;
//   - a game that is over passes its state through unchanged.
//
// Bound on this card: bytes.  A step reads the state (the 432-byte board,
// 28 bytes of queue, 8 of key and 25 of other fields at 10x20) and the
// action, and writes the same, the 200-byte observation, the reward,
// terminated and lines: 497 bytes in and 702 out an env, 78.6 MB at
// B = 65536 (23.5 us at 3.35 TB/s).  fn_reset reads the key and writes the
// returned key, the state and the observation (701 bytes an env);
// fn_observe reads the board and 17 bytes of fields and writes the
// observation (649 bytes).  The integer work (a few 16-cell window tests, a
// drop of at most H window tests, on a lock a 20-row compaction, two
// threefry blocks and, on a refill, seven more and a 7-key sort) is below
// the bytes at full occupancy.
//
// Geometry is fixed at compile time by the TETRIS_* defines
// (kernels.py:fn_defines), one library per geometry and piece set: the
// boards of a block live in kEnvs * CELLS bytes of shared memory, which
// with their windows stay within 48 KB (CELLS <= 3056 at 16 envs a block),
// and a piece's S x S matrix is one 64-bit mask (S <= 8).

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

#ifndef TETRIS_HEIGHT
#define TETRIS_HEIGHT 20
#endif
#ifndef TETRIS_WIDTH
#define TETRIS_WIDTH 10
#endif
#ifndef TETRIS_PAD
#define TETRIS_PAD 4
#endif
#ifndef TETRIS_QS
#define TETRIS_QS 7
#endif
#ifndef TETRIS_NP
#define TETRIS_NP 7
#endif
#ifndef TETRIS_S
#define TETRIS_S 4
#endif

// The launchers' argument types stay outside the anonymous namespace, so
// that the extern "C" launchers keep external linkage.  Pointers to the 10
// fields of an FnState, in field order:
struct FnPtrs {
  uint32_t* rng_key;   // [B, 2]
  int8_t* board;       // [B, H, PW]
  int32_t* piece;      // [B]
  int32_t* rotation;   // [B]
  int32_t* x;          // [B]
  int32_t* y;          // [B]
  int32_t* queue;      // [B, QS]
  int32_t* queue_index;  // [B]
  uint8_t* game_over;  // [B] (torch.bool)
  float* score;        // [B]
};

struct FnParams {
  int gravity;
  int uniform;
};

namespace {

constexpr int HEIGHT = TETRIS_HEIGHT;
constexpr int WIDTH = TETRIS_WIDTH;
constexpr int PAD = TETRIS_PAD;
constexpr int H = HEIGHT + PAD;      // padded height
constexpr int PW = WIDTH + 2 * PAD;  // padded width
constexpr int CELLS = H * PW;        // bytes of a board
constexpr int OBS = HEIGHT * WIDTH;  // bytes of an observation
constexpr int QS = TETRIS_QS;
constexpr int NP = TETRIS_NP;
constexpr int S = TETRIS_S;
constexpr int SPAWN_X = PW / 2 - 2;  // spawn_xy_fn: the padded matrix width 4, whatever S
constexpr int8_t BEDROCK = 1;
// Envs a block: 64, 32 or 16, as many as fit their boards and windows
// (16 bytes each, struct Active) in the 48 KB of shared memory a block has
// without opting in.
constexpr int kSharedBytes = 48 * 1024;
constexpr int kEnvs = 64 * (CELLS + 16) <= kSharedBytes ? 64 : 32 * (CELLS + 16) <= kSharedBytes ? 32 : 16;
constexpr int kSmem = kEnvs * CELLS;
static_assert(PAD >= 1 && HEIGHT >= 1 && WIDTH >= 1 && S <= 8 && S <= H && S <= PW,
              "kernels.py:fn_defines limits");
static_assert(kEnvs * (CELLS + 16) <= kSharedBytes, "a block's boards fit 48 KB of shared memory");
// Threads a block: threads 0 .. kEnvs - 1 each play one env, and all of them
// move the boards and write the observations.
constexpr int kThreads = 256;
static_assert(QS >= 1 && QS <= 32 && QS <= NP, "the queue lives in registers and draws pieces");
constexpr int kRounds = QS > 1 ? 1 : 0;  // jax.random.permutation's rounds, up to 1625 items

// The observation's view of an env: its clamped window and its piece's cells
// there (0 when the game is over: nothing is stamped).
struct Active {
  int xc, yc;
  uint64_t mask;
};

// piece_matrix: bit i * S + j of entry p * 4 + r; an index outside the table
// gives no cells, as the one-hot contraction does.
__device__ __forceinline__ uint64_t piece_mask(const uint64_t* masks, int p, int r) {
  if (p < 0 || p >= NP || r < 0 || r > 3) return 0;
  return __ldg(masks + p * 4 + r);
}

// _clamp_start: lax.dynamic_slice's start normalisation.
__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

// A filled cell of the piece over a cell > 0 of the window at (xc, yc).
__device__ __forceinline__ bool window_hits(const int8_t* b, uint64_t m, int xc, int yc) {
  for (; m; m &= m - 1) {
    const int k = __ffsll(static_cast<long long>(m)) - 1;
    if (b[(yc + k / S) * PW + xc + k % S] > 0) return true;
  }
  return false;
}

__device__ __forceinline__ bool collides(const int8_t* b, uint64_t m, int x, int y) {
  return window_hits(b, m, clamp_start(x, PW - S, PW), clamp_start(y, H - S, H));
}

// drop_distance: free window offsets d = 0, 1, .. before the first hit, the
// row start clipped (no wrap) to [0, H - S], at most H.  Past the clip the
// window no longer moves, so a miss there is a miss to the end.
__device__ int drop_distance(const int8_t* b, uint64_t m, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  for (int d = 0; d < H; ++d) {
    const int row = y + 1 + d;
    if (window_hits(b, m, xc, min(max(row, 0), H - S))) return d;
    if (row >= H - S) break;
  }
  return H;
}

// project: ADD id into the piece's cells of the clamped window (int8 wraps).
__device__ void stamp(int8_t* b, uint64_t m, int x, int y, int id) {
  const int xc = clamp_start(x, PW - S, PW), yc = clamp_start(y, H - S, H);
  for (; m; m &= m - 1) {
    const int k = __ffsll(static_cast<long long>(m)) - 1;
    int8_t* cell = b + (yc + k / S) * PW + xc + k % S;
    *cell = static_cast<int8_t>(*cell + id);
  }
}

// clear_lines_compat in place: the full playfield rows go, the others move
// down in order, the n top rows become copies of the pre-clear row 0, and
// the frame is bedrock again.  Returns n.
__device__ int clear_lines_compat(int8_t* b) {
  int w = HEIGHT - 1;
  for (int r = HEIGHT - 1; r >= 0; --r) {
    const int8_t* row = b + r * PW + PAD;
    bool full = true;
    for (int c = 0; c < WIDTH && full; ++c) full = row[c] > 0;
    if (full) continue;
    if (w != r) {
      for (int c = 0; c < WIDTH; ++c) b[w * PW + PAD + c] = row[c];
    }
    --w;
  }
  const int n = w + 1;
  for (int r = 1; r < n; ++r) {
    for (int c = 0; c < WIDTH; ++c) b[r * PW + PAD + c] = b[PAD + c];
  }
  for (int r = 0; r < H; ++r) {
    for (int c = 0; c < PW; ++c) {
      if (r >= HEIGHT || c < PAD || c >= PAD + WIDTH) b[r * PW + c] = BEDROCK;
    }
  }
  return n;
}

// score_fn: 1 -> 100, 2 -> 300, 3 -> 500, 4 -> 800.
__device__ __forceinline__ int score_fn(int n) { return n == 4 ? 800 : n > 0 ? n * 200 - 100 : 0; }

// A fresh queue from key (k0, k1): create_bag's permutation (one round:
// split, 32-bit sort keys from the subkey, a stable sort) or create_uniform's
// randint(0, QS - 1).
__device__ void fresh_queue(uint32_t k0, uint32_t k1, bool uniform, int32_t (&q)[QS]) {
  if (uniform) {
    constexpr uint32_t span = QS - 1 > 0 ? QS - 1 : 1;
    constexpr uint32_t mult = ((65536u % span) * (65536u % span)) % span;
    const uint2 khi = tf::block(k0, k1, 0u, 0u), klo = tf::block(k0, k1, 0u, 1u);
#pragma unroll
    for (int i = 0; i < QS; ++i) {
      const uint32_t hi = tf::bits(khi.x, khi.y, 0u, i), lo = tf::bits(klo.x, klo.y, 0u, i);
      q[i] = static_cast<int32_t>(((hi % span) * mult + lo % span) % span);
    }
    return;
  }
  uint32_t sk[QS];
#pragma unroll
  for (int i = 0; i < QS; ++i) q[i] = i;
  for (int round = 0; round < kRounds; ++round) {
    const uint2 next = tf::block(k0, k1, 0u, 0u), sub = tf::block(k0, k1, 0u, 1u);
#pragma unroll
    for (int i = 0; i < QS; ++i) sk[i] = tf::bits(sub.x, sub.y, 0u, i);
    for (int i = 1; i < QS; ++i) {  // insertion sort: equal keys keep their order
      const uint32_t key = sk[i];
      const int32_t val = q[i];
      int j = i;
      for (; j > 0 && sk[j - 1] > key; --j) {
        sk[j] = sk[j - 1];
        q[j] = q[j - 1];
      }
      sk[j] = key;
      q[j] = val;
    }
    k0 = next.x;
    k1 = next.y;
  }
}

// Moves nbytes between global and shared memory, the block's threads on
// neighbouring words: 16-byte words where both ends allow, else bytes.
__device__ __forceinline__ void block_copy(void* dst, const void* src, int nbytes) {
  int i0 = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15u) == 0) {
    for (int i = threadIdx.x; i < nbytes / 16; i += blockDim.x)
      static_cast<uint4*>(dst)[i] = static_cast<const uint4*>(src)[i];
    i0 = nbytes & ~15;
  }
  for (int i = i0 + threadIdx.x; i < nbytes; i += blockDim.x)
    static_cast<int8_t*>(dst)[i] = static_cast<const int8_t*>(src)[i];
}

// observe at byte i of the block's observations: the playfield cell (> 0 is
// 1) minus 1 where the active piece covers it.
__device__ __forceinline__ uint32_t obs_cell(const int8_t* boards, const Active* act, int i) {
  const int e = i / OBS, rc = i - e * OBS, r = rc / WIDTH, c = rc - r * WIDTH + PAD;
  int v = boards[e * CELLS + r * PW + c] > 0;
  const int dr = r - act[e].yc, dc = c - act[e].xc;
  if (dr >= 0 && dr < S && dc >= 0 && dc < S && ((act[e].mask >> (dr * S + dc)) & 1u)) v -= 1;
  return static_cast<uint8_t>(v);
}

// observe for the block's nb envs, from their boards (shared or global
// memory) and windows: 4-byte words, neighbouring threads on neighbouring
// words, where obs starts on a 4-byte boundary, the ragged tail a byte a
// thread.
__device__ void write_obs(int8_t* obs, const int8_t* boards, const Active* act, int nb) {
  const int n = nb * OBS;
  const int words = (reinterpret_cast<uintptr_t>(obs) & 3u) == 0 ? n / 4 : 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int i = 4 * w;
    reinterpret_cast<uint32_t*>(obs)[w] = obs_cell(boards, act, i) | obs_cell(boards, act, i + 1) << 8 |
                                          obs_cell(boards, act, i + 2) << 16 |
                                          obs_cell(boards, act, i + 3) << 24;
  }
  for (int i = 4 * words + threadIdx.x; i < n; i += blockDim.x)
    obs[i] = static_cast<int8_t>(obs_cell(boards, act, i));
}

__device__ __forceinline__ Active active(const uint64_t* masks, int piece, int rot, int x, int y,
                                         bool over) {
  return {clamp_start(x, PW - S, PW), clamp_start(y, H - S, H),
          over ? 0ull : piece_mask(masks, piece, rot)};
}

__global__ void __launch_bounds__(kThreads) fn_step_kernel(FnPtrs in, FnPtrs out,
                                                        const int32_t* __restrict__ action,
                                                        int8_t* __restrict__ obs,
                                                        float* __restrict__ reward,
                                                        uint8_t* __restrict__ terminated,
                                                        int32_t* __restrict__ lines,
                                                        const uint64_t* __restrict__ masks,
                                                        const int32_t* __restrict__ ids, int B,
                                                        FnParams p) {
  extern __shared__ __align__(16) int8_t boards[];
  __shared__ Active act[kEnvs];
  const int e0 = blockIdx.x * kEnvs, nb = min(kEnvs, B - e0), t = threadIdx.x;
  block_copy(boards, in.board + static_cast<long long>(e0) * CELLS, nb * CELLS);
  __syncthreads();
  if (t < nb) {
    const int e = e0 + t;
    int8_t* b = boards + t * CELLS;
    const bool over_in = in.game_over[e];
    const int piece = in.piece[e];
    int rot = in.rotation[e], x = in.x[e], y = in.y[e], qi = in.queue_index[e];
    const float score = in.score[e];
    uint32_t k0 = in.rng_key[2 * e], k1 = in.rng_key[2 * e + 1];
    int32_t q[QS];
#pragma unroll
    for (int i = 0; i < QS; ++i) q[i] = in.queue[static_cast<long long>(e) * QS + i];
    int cur = piece, n = 0;
    bool over = over_in;
    float new_score = score;
    if (!over_in) {
      const int a = action[e];
      uint64_t m = piece_mask(masks, piece, rot);
      // the horizontal move, with the old rotation
      const int dx = a == 0 ? -1 : a == 1 ? 1 : 0;
      if (dx != 0 && !collides(b, m, x + dx, y)) x += dx;
      // down or hard drop, at the new x
      int y_new = y, move = 0;
      if (a == 2 && !collides(b, m, x, y + 1)) {
        y_new = y + 1;
        move = 1;
      } else if (a == 6) {
        const int d = drop_distance(b, m, x, y);
        y_new = y + d;
        move = 2 * d;
      }
      // rotation, checked at the new x and y
      const int rd = a == 3 ? -1 : a == 4 ? 1 : 0;
      if (rd != 0) {
        const int rc = ((rot + rd) % 4 + 4) % 4;
        if (!collides(b, piece_mask(masks, piece, rc), x, y_new)) rot = rc;
      }
      m = piece_mask(masks, piece, rot);
      // gravity, with the new rotation; a lock on a blocked fall or a hard drop
      int y_g = y_new;
      bool lock = a == 6;
      if (p.gravity) {
        if (collides(b, m, x, y_new + 1)) lock = true;
        else y_g = y_new + 1;
      }
      int lock_reward = 0;
      if (lock) {
        const int at_id = min(max(piece < 0 ? piece + NP : piece, 0), NP - 1);
        stamp(b, m, x, y_g, __ldg(ids + at_id));
        n = clear_lines_compat(b);
        lock_reward = score_fn(n);
        const uint2 next = tf::block(k0, k1, 0u, 0u);
        int idx = qi;
        if (qi >= QS) {
          const uint2 sub = tf::block(k0, k1, 0u, 1u);
          fresh_queue(sub.x, sub.y, p.uniform != 0, q);
          idx = 0;
        }
        cur = q[min(max(idx < 0 ? idx + QS : idx, 0), QS - 1)];
        qi = idx + 1;
        k0 = next.x;
        k1 = next.y;
        rot = 0;
        x = SPAWN_X;
        y = 0;
        over = collides(b, piece_mask(masks, cur, 0), SPAWN_X, 0);
      } else {
        y = y_g;
        over = false;
      }
      new_score = __fadd_rn(__fadd_rn(score, static_cast<float>(move)),
                            static_cast<float>(lock_reward));
    }
    out.rng_key[2 * e] = k0;
    out.rng_key[2 * e + 1] = k1;
    out.piece[e] = cur;
    out.rotation[e] = rot;
    out.x[e] = x;
    out.y[e] = y;
#pragma unroll
    for (int i = 0; i < QS; ++i) out.queue[static_cast<long long>(e) * QS + i] = q[i];
    out.queue_index[e] = qi;
    out.game_over[e] = over;
    out.score[e] = new_score;
    reward[e] = __fsub_rn(new_score, score);
    terminated[e] = over;
    lines[e] = n;
    act[t] = active(masks, cur, rot, x, y, over);
  }
  __syncthreads();
  block_copy(out.board + static_cast<long long>(e0) * CELLS, boards, nb * CELLS);
  write_obs(obs + static_cast<long long>(e0) * OBS, boards, act, nb);
}

__global__ void __launch_bounds__(kThreads) fn_reset_kernel(const uint32_t* __restrict__ keys,
                                                         uint32_t* __restrict__ keys_out, FnPtrs out,
                                                         int8_t* __restrict__ obs,
                                                         const uint64_t* __restrict__ masks, int B,
                                                         int uniform) {
  extern __shared__ __align__(16) int8_t boards[];
  __shared__ Active act[kEnvs];
  const int e0 = blockIdx.x * kEnvs, nb = min(kEnvs, B - e0), t = threadIdx.x;
  // create_board: zeros inside, bedrock on the left, right and bottom
  for (int i = t; i < nb * CELLS; i += blockDim.x) {
    const int r = (i % CELLS) / PW, c = i % PW;
    boards[i] = (r >= HEIGHT || c < PAD || c >= PAD + WIDTH) ? BEDROCK : 0;
  }
  if (t < nb) {
    const int e = e0 + t;
    // the key splits once: the first half draws the queue and comes back,
    // the second becomes the state's stream
    const uint2 first = tf::block(keys[2 * e], keys[2 * e + 1], 0u, 0u);
    const uint2 second = tf::block(keys[2 * e], keys[2 * e + 1], 0u, 1u);
    int32_t q[QS];
    fresh_queue(first.x, first.y, uniform != 0, q);
    keys_out[2 * e] = first.x;
    keys_out[2 * e + 1] = first.y;
    out.rng_key[2 * e] = second.x;
    out.rng_key[2 * e + 1] = second.y;
    out.piece[e] = q[0];
    out.rotation[e] = 0;
    out.x[e] = SPAWN_X;
    out.y[e] = 0;
#pragma unroll
    for (int i = 0; i < QS; ++i) out.queue[static_cast<long long>(e) * QS + i] = q[i];
    out.queue_index[e] = 1;
    out.game_over[e] = 0;
    out.score[e] = 0.0f;
    act[t] = active(masks, q[0], 0, SPAWN_X, 0, false);
  }
  __syncthreads();
  block_copy(out.board + static_cast<long long>(e0) * CELLS, boards, nb * CELLS);
  write_obs(obs + static_cast<long long>(e0) * OBS, boards, act, nb);
}

__global__ void __launch_bounds__(kThreads) fn_observe_kernel(
    const int8_t* __restrict__ board, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const int32_t* __restrict__ x,
    const int32_t* __restrict__ y, const uint8_t* __restrict__ game_over,
    const uint64_t* __restrict__ masks, int8_t* __restrict__ obs, int B) {
  __shared__ Active act[kEnvs];
  const int e0 = blockIdx.x * kEnvs, nb = min(kEnvs, B - e0), t = threadIdx.x;
  if (t < nb) {
    const int e = e0 + t;
    act[t] = active(masks, piece[e], rotation[e], x[e], y[e], game_over[e]);
  }
  __syncthreads();
  write_obs(obs + static_cast<long long>(e0) * OBS, board + static_cast<long long>(e0) * CELLS, act,
            nb);
}

int blocks_for(int B) { return (B + kEnvs - 1) / kEnvs; }

}  // namespace

extern "C" int fn_step_launch(const FnPtrs* in, const FnPtrs* out, const void* action, void* obs,
                              void* reward, void* terminated, void* lines, const void* masks,
                              const void* ids, int B, const FnParams* params, void* stream) {
  fn_step_kernel<<<blocks_for(B), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      *in, *out, static_cast<const int32_t*>(action), static_cast<int8_t*>(obs),
      static_cast<float*>(reward), static_cast<uint8_t*>(terminated), static_cast<int32_t*>(lines),
      static_cast<const uint64_t*>(masks), static_cast<const int32_t*>(ids), B, *params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fn_reset_launch(const void* keys, void* keys_out, const FnPtrs* out, void* obs,
                               const void* masks, int B, int uniform, void* stream) {
  fn_reset_kernel<<<blocks_for(B), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(keys_out), *out,
      static_cast<int8_t*>(obs), static_cast<const uint64_t*>(masks), B, uniform);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fn_observe_launch(const void* board, const void* piece, const void* rotation,
                                 const void* x, const void* y, const void* game_over,
                                 const void* masks, void* obs, int B, void* stream) {
  fn_observe_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(board), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const int32_t*>(x),
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(game_over),
      static_cast<const uint64_t*>(masks), static_cast<int8_t*>(obs), B);
  return static_cast<int>(cudaGetLastError());
}
