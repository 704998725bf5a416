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
// owns one env and branches: the env's 24 rows, bag, queue and holder live
// in registers (every array index below is a compile-time constant after
// unrolling), the hit map of a piece over all window starts is one 32-bit
// mask, and the key advances only where a draw happens.  State arrays are
// batch-minor ([rows, B]), so every load and store of a field is coalesced
// along B.
//
// Bound on this card: bytes.  One env-step reads the state (24 rows + 2 key
// words + 7 bag + 4 queue + 2 holder words + 9 scalar words = 48 words, and
// 2 bools: 194 bytes) and the action, and writes the state plus reward, done
// and lines: 198 bytes in, 203 bytes out, 401 bytes in all, 0.120 ns per
// env-step at 3.35 TB/s.  The integer work (a few hundred
// instructions per env) stays under that at full occupancy; the design keeps
// to one pass over the state and no scratch traffic.
//
// Geometry is the default EngineConfig (10x20 playfield, padding 4, queue 4,
// holder 1, the 7 standard pieces); the Python wrapper refuses others.  The
// state may be stepped in place (each thread reads all of its env before it
// writes) but the wrapper writes to new buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int HEIGHT = 20;
constexpr int WIDTH = 10;
constexpr int PAD = 4;
constexpr int H = HEIGHT + PAD;      // padded height: 24 rows
constexpr int PW = WIDTH + 2 * PAD;  // padded width: 18 bits
constexpr int S = 4;                 // piece box side
constexpr int NP = 7;                // pieces
constexpr int QS = 4;                // queue size
constexpr int HS = 1;                // holder size
constexpr uint32_t PLAY_MASK = ((1u << WIDTH) - 1u) << PAD;
constexpr uint32_t SIDE_MASK = ((1u << PAD) - 1u) | (((1u << PAD) - 1u) << (PAD + WIDTH));
constexpr uint32_t FULL_ROW = (1u << PW) - 1u;

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t M1 = 0x85EBCA6Bu;
constexpr uint32_t M2 = 0xC2B2AE35u;

enum : int { kLeft = 0, kRight = 1, kDown = 2, kCw = 3, kCcw = 4, kDrop = 5, kSwap = 6 };

}  // namespace

// Pointers to the 17 batch-minor fields of a TurboState, in field order.
struct StatePtrs {
  uint32_t* key;           // [2, B]
  uint32_t* rows;          // [H, B]
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

struct Env {
  uint32_t k0, k1;
  uint32_t rows[H];
  int piece, rotation, x, y;
  int bag[NP];
  int bag_index;
  int queue[QS];
  int holder_piece[HS], holder_rotation[HS];
  int holder_count;
  bool has_swapped, game_over;
  float score;
  int lines, steps;
};

// ---- counter RNG (ops/rng.py) ---------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 13;
  x *= M2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t next_bits(Env& e) {
  const uint32_t c0 = e.k0 + GOLDEN;
  const uint32_t c1 = e.k1 + (c0 < e.k0 ? 1u : 0u);
  e.k0 = c0;
  e.k1 = c1;
  return fmix32(c0 ^ fmix32(c1));
}

__device__ __forceinline__ int randint(Env& e, uint32_t n) {
  return static_cast<int>(((next_bits(e) >> 16) * n) >> 16);
}

// Fisher-Yates in the draw order of ops/rng.py:shuffle, into e.bag.
__device__ __forceinline__ void shuffle_bag(Env& e) {
#pragma unroll
  for (int l = 0; l < NP; ++l) e.bag[l] = l;
#pragma unroll
  for (int i = NP - 1; i > 0; --i) {
    const int j = randint(e, static_cast<uint32_t>(i + 1));
    const int vi = e.bag[i];
    int vj = 0;
#pragma unroll
    for (int l = 0; l < NP; ++l) vj = (l == j) ? e.bag[l] : vj;
#pragma unroll
    for (int l = 0; l < NP; ++l) e.bag[l] = (l == j) ? vi : e.bag[l];
    e.bag[i] = vj;
  }
}

// tetromino_randomizer.py: bag_draw (key advances only on a refill) or
// uniform_draw.
__device__ __forceinline__ int draw(Env& e, bool uniform) {
  if (uniform) return randint(e, NP);
  int idx = e.bag_index;
  if (idx >= NP) {
    shuffle_bag(e);
    idx = 0;
  }
  int piece = 0;
#pragma unroll
  for (int l = 0; l < NP; ++l) piece = (l == idx) ? e.bag[l] : piece;
  e.bag_index = idx + 1;
  return piece;
}

// FIFO pop plus backfill (core/turbo.py:_queue_draw).
__device__ __forceinline__ int queue_draw(Env& e, bool uniform) {
  const int piece = e.queue[0];
  const int refill = draw(e, uniform);
#pragma unroll
  for (int i = 0; i < QS - 1; ++i) e.queue[i] = e.queue[i + 1];
  e.queue[QS - 1] = refill;
  return piece;
}

// ---- bit helpers (core/turbo.py:157-298) ----------------------------------

__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

// Packed S*S-bit word of (piece, rotation); 0 outside the table.
__device__ __forceinline__ uint32_t piece_word(const uint32_t* packed, int piece, int rot) {
  const int idx = piece * 4 + rot;
  return (idx >= 0 && idx < NP * 4) ? __ldg(packed + idx) : 0u;
}

__device__ __forceinline__ uint32_t piece_row(uint32_t word, int s) {
  return (word >> (s * S)) & ((1u << S) - 1u);
}

__device__ __forceinline__ int spawn_x(const int32_t* box, int piece) {
  const int b = (piece >= 0 && piece < NP) ? __ldg(box + piece) : 0;
  return PW / 2 - b / 2;
}

// Overlap flags of the x-shifted piece at every window start y in [0, H-S],
// bit y of the result (_hit_map restricted to the starts that are read).
__device__ __forceinline__ uint32_t hit_map(const uint32_t (&rows)[H], uint32_t word, int x) {
  const int xc = clamp_start(x, PW - S, PW);
  const uint32_t sp0 = piece_row(word, 0) << xc;
  const uint32_t sp1 = piece_row(word, 1) << xc;
  const uint32_t sp2 = piece_row(word, 2) << xc;
  const uint32_t sp3 = piece_row(word, 3) << xc;
  uint32_t hm = 0;
#pragma unroll
  for (int y = 0; y <= H - S; ++y) {
    const uint32_t acc =
        (rows[y] & sp0) | (rows[y + 1] & sp1) | (rows[y + 2] & sp2) | (rows[y + 3] & sp3);
    hm |= (acc != 0u ? 1u : 0u) << y;
  }
  return hm;
}

__device__ __forceinline__ bool collision_at(uint32_t hm, int y) {
  return (hm >> clamp_start(y, H - S, H)) & 1u;
}

// _drop_from_map: first hit at or below y+1; first_hit == 0 gives 0.
__device__ __forceinline__ int drop_from_map(uint32_t hm, int y) {
  const int z = min(max(y + 1, 0), H - S);
  const uint32_t eligible = hm & (0xFFFFFFFFu << z);
  const int first_hit = eligible ? __ffs(eligible) - 1 : 2 * H;
  const int dist = min(max(first_hit - (y + 1), 0), H);
  return first_hit == 0 ? 0 : dist;
}

__device__ __forceinline__ void project(uint32_t (&rows)[H], uint32_t word, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  const int yc = clamp_start(y, H - S, H);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int off = h - yc;
    if (off >= 0 && off < S) rows[h] |= piece_row(word, off) << xc;
  }
}

// _clear_lines: full playfield rows go; a kept row moves down by the number
// of full rows below it, if that shift is <= max_clear.  Returns the count.
__device__ __forceinline__ int clear_lines(uint32_t (&rows)[H], int max_clear) {
  bool filled[HEIGHT];
  int sh[HEIGHT];
  int below = 0;
#pragma unroll
  for (int h = HEIGHT - 1; h >= 0; --h) {
    filled[h] = (rows[h] & PLAY_MASK) == PLAY_MASK;
    sh[h] = below;
    below += filled[h] ? 1 : 0;
  }
  if (below == 0) return 0;
  uint32_t out[HEIGHT];
#pragma unroll
  for (int d = 0; d < HEIGHT; ++d) {
    out[d] = SIDE_MASK;
#pragma unroll
    for (int k = 0; k <= d; ++k) {
      if (!filled[d - k] && sh[d - k] == k && k <= max_clear) out[d] = rows[d - k];
    }
  }
#pragma unroll
  for (int d = 0; d < HEIGHT; ++d) rows[d] = out[d];
  return below;
}

__device__ __forceinline__ bool spawn_overlap(const uint32_t (&rows)[H], uint32_t word, int x) {
  const int xc = clamp_start(x, PW - S, PW);
  bool over = false;
#pragma unroll
  for (int s = 0; s < S; ++s) over |= (rows[s] & (piece_row(word, s) << xc)) != 0u;
  return over;
}

// _init_from_key: a fresh episode from the key words.
__device__ __forceinline__ void init_env(Env& e, uint32_t k0, uint32_t k1, bool uniform,
                                         const int32_t* box) {
  e.k0 = k0;
  e.k1 = k1;
  shuffle_bag(e);
  e.bag_index = 0;
  int active;
  if (!uniform && QS + 1 <= NP) {
    active = e.bag[0];
#pragma unroll
    for (int i = 0; i < QS; ++i) e.queue[i] = e.bag[1 + i];
    e.bag_index = QS + 1;
  } else {
    active = draw(e, uniform);
#pragma unroll
    for (int i = 0; i < QS; ++i) e.queue[i] = draw(e, uniform);
  }
#pragma unroll
  for (int h = 0; h < H; ++h) e.rows[h] = h < HEIGHT ? SIDE_MASK : FULL_ROW;
  e.piece = active;
  e.rotation = 0;
  e.x = spawn_x(box, active);
  e.y = 0;
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    e.holder_piece[i] = 0;
    e.holder_rotation[i] = 0;
  }
  e.holder_count = 0;
  e.has_swapped = false;
  e.game_over = false;
  e.score = 0.0f;
  e.lines = 0;
  e.steps = 0;
}

__device__ __forceinline__ void load_env(Env& e, const StatePtrs& p, int b, int B) {
  e.k0 = p.key[b];
  e.k1 = p.key[B + b];
#pragma unroll
  for (int h = 0; h < H; ++h) e.rows[h] = p.rows[h * B + b];
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
  for (int h = 0; h < H; ++h) p.rows[h * B + b] = e.rows[h];
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

// _swap from the pre-step state: with the holder full, key, bag and queue
// stay as they are; with it empty the new piece is drawn from the queue.
__device__ __forceinline__ void swap_piece(Env& e, bool uniform, const int32_t* box) {
  const bool full = e.holder_count >= HS;
  int new_piece, new_rot;
  if (full) {
    new_piece = e.holder_piece[0];
    new_rot = e.holder_rotation[0];
#pragma unroll
    for (int i = 0; i < HS - 1; ++i) {
      e.holder_piece[i] = e.holder_piece[i + 1];
      e.holder_rotation[i] = e.holder_rotation[i + 1];
    }
    e.holder_piece[HS - 1] = e.piece;
    e.holder_rotation[HS - 1] = e.rotation;
  } else {
    const int idx = min(max(e.holder_count, 0), HS - 1);
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      if (i == idx) {
        e.holder_piece[i] = e.piece;
        e.holder_rotation[i] = e.rotation;
      }
    }
    new_piece = queue_draw(e, uniform);
    new_rot = 0;
  }
  e.piece = new_piece;
  e.rotation = new_rot;
  e.x = spawn_x(box, new_piece);
  e.y = 0;
  e.holder_count = min(e.holder_count + 1, HS);
  e.has_swapped = true;
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
    if (a == kSwap && !e.has_swapped) {
      swap_piece(e, uniform, box);
    } else {
      const uint32_t w = piece_word(packed, e.piece, e.rotation);
      const int dx = a == kLeft ? -1 : (a == kRight ? 1 : 0);
      int x = e.x;
      if (dx != 0 && !collision_at(hit_map(e.rows, w, e.x + dx), e.y)) x = e.x + dx;
      int y = e.y;
      if (a == kDown && !collision_at(hit_map(e.rows, w, x), e.y + 1)) y = e.y + 1;
      const int rot_dir = a == kCw ? 1 : (a == kCcw ? -1 : 0);
      if (rot_dir != 0) {
        const int rot_cand = (e.rotation + rot_dir) & 3;
        if (!collision_at(hit_map(e.rows, piece_word(packed, e.piece, rot_cand), x), y))
          e.rotation = rot_cand;
      }
      e.x = x;
      e.y = y;
    }
    // -- phase 2: gravity, then commit on rest or hard drop
    const uint32_t w1 = piece_word(packed, e.piece, e.rotation);
    const uint32_t hm1 = hit_map(e.rows, w1, e.x);
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
