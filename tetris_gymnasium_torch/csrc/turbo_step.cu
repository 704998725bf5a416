// Turbo engine step and reset for Hopper (sm_90a): one thread or a group of
// lanes per env, and the board observation in the same launch.
//
// Replaces the JAX turbo step, tetris_gymnasium_tpu/core/turbo.py:step (:639)
// with _apply_action (:545), _swap (:507), _commit (:580), _clear_lines (:364)
// and _init_from_key (:440), plus the counter RNG (ops/rng.py:48-114) and the
// 7-bag draw (components/tetromino_randomizer.py:bag_draw :35) inside it;
// with an obs output also observe_board (:738) of the state it stores.  The
// plain PyTorch twins are tetris_gymnasium_torch/core/turbo.py:step_plain
// and observe_board_plain; every output is bit-equal to them.
//
// On the TPU the step is branch-free vector code over [H, B] tiles, with
// one-hot selects standing in for per-env control flow.  Here an env's
// control flow branches: its bag, queue, holder and key live in registers
// (every array index below is a compile-time constant after unrolling), the
// hit map of a piece over all window starts is one 32- or 64-bit mask, and
// the key advances only where a draw happens.  State arrays are batch-minor
// ([rows, B], [H, NW, B] for the rows).
//
// Bound on this card: bytes.  One env-step reads the state (H * NW row
// words + 2 key words + NP bag + QS queue + 2 * HS holder words + 9 scalar
// words, and 2 bools; at the default 10x20 board 24 rows, 194 bytes) and
// the action, and writes the state plus reward, done and lines: 401 bytes
// at 10x20, 593 at 30x20 (NW = 2) and 61x12 (NW = 3, 16 rows).  The
// observation adds height * width bytes written: 601 bytes an env at 10x20
// (1.47 us at B = 8192, 0.0117 ms at 65536, at 3.35 TB/s), 593 + 600 at
// 30x20.  Below the bound lies the launch floor, what the card takes for
// the smallest launch (a CUDA graph of empty kernels, 0.8 us on an H100),
// and a kernel that loads and stores its state once takes about twice that.
//
// What bounds the step at the main paths' batches (PPO's rollout at 8192,
// the evaluation at 512, the DQNs at 1024) is not bytes but the chain of
// one env's step: the state's loads, the action's hit map, gravity's hit
// map, the commit (project, line clear, draw, spawn test), the bag's
// Fisher-Yates and the reset, each waiting for the last; a warp waits for
// its slowest env.  With one thread an env (L = 1, 128 envs a block) B =
// 8192 fills 64 of 132 SMs with one warp a scheduler.  With L = 8 lanes an
// env (16 envs a block; turbo_band.cuh) every lane runs the scalar chain,
// so the RNG stream cannot diverge, but holds only a band of ceil(H / 8)
// rows: the hit maps test 3 window starts a lane and OR-reduce over the
// group, the full rows are OR-reduced and the line clear moves rows
// through shared memory, and B = 8192 gives 512 blocks, several on every
// SM.  That shortens the row work, not the scalar chain, which the chip
// shows taking most of the time (tools/ablate_turbo_step.py at B = 512,
// L = 8: 3.3 us a step, 1.7 us with loads and stores alone, 0.6 us less
// without the action's effect, 0.2 us less without the swap or the draw),
// and it repeats the scalar work and its loads on every lane of the group.
// So on an H100 (PERF.md) the 8-lane build wins below B = 8192 without the
// observation and below 16384 with it, where one thread's byte-wise writes
// of 200 cells a step are its slow part; one thread an env wins above, and
// at 65536 (4 warps a scheduler) reaches 88% of its byte bound.
// kernels.py:step_lanes picks L from B.
//
// With the observation, each lane writes the cells of the rows it holds
// into the block's frames in shared memory, and the block stores its frames,
// contiguous in the output, with 16-byte words (observe_board.cu's staging).
//
// With the sample (PPO's rollout on this engine: kSample, built only with
// the observation, at L = 1 and 8), the launch also takes the tail of
// tetris_gymnasium_tpu/rl/ppo.py:policy_step (:184-187) that ppo_sample.cu
// runs on its own (sample_group.cuh, shared with flagship_step.cu's
// sampling build): it reads the policy's logits f32[B, 8] and the step's
// key, draws JAX's Gumbel noise, takes the argmax and the log-prob in
// ppo_sample.cu's butterfly, writes the action and the log-prob, and steps
// the env with that action.  At L = 8 lane a of the group is action a and
// the reductions are shuffles inside the group; at L = 1 one thread draws
// the eight and repeats each lane's arithmetic of the butterfly, so both
// builds are bit-equal to ppo_sample.cu.  The logits load and the eight
// threefry blocks do not depend on the env's state and are issued before
// its loads; what the chain gains is the reductions and a compare.  It adds
// 32 bytes of logits read and 8 bytes written an env (641 bytes at 10x20
// with the observation: 1.57 us at B = 8192, 0.0125 ms at 65536, at 3.35
// TB/s) and 8 threefry blocks (about 800 32-bit operations an env, 0.20 us
// at 8192 at 33.5e12 a second), so bytes still bound it; it saves
// ppo_sample's launch, which ran at about two launch floors: on an H100
// 0.00590 ms at B = 8192 against 0.00750 for ppo_sample and then this
// kernel with the observation (PERF.md).
//
// turbo_init writes a fresh batch (202 bytes an env at 10x20 with the keys
// read: 0.49 us at B = 8192, 3.95 us at 65536, at 3.35 TB/s), a block for
// up to 128 envs (min(128, ceil(B / SMs)) rounded up to whole warps, so that
// the vector env's 8192 envs spread over the SMs) of 256 threads.  The rows tensor
// [H, NW, B] holds one word per (h, j) across B, so the warps after the
// envs' stream the block's share of it as 16-byte words, four envs a
// store, beside the env warps' chains, each thread carrying its chunk's
// segment from store to store.  An env's chain is short: its key is one
// 8-byte load (or two coalesced 4-byte loads of the state's [2, B] key,
// which turbo.init_from_key passes as it lies), draw i of the bag's shuffle
// is next_bits at the 64-bit counter (k1:k0) + (i + 1) * GOLDEN so that all
// NP - 1 draws mix at once, the bag is 4-bit entries of one word (NP <= 8)
// so that a swap is a few shifts and masks, and the spawn column comes from
// the box table by shuffle; then the scalar fields' coalesced stores.  The
// launch alone takes ~0.0011 ms on an H100 and the key's round trip and the
// field stores most of the rest below 65536 (PERF.md).  The auto-reset of
// the steps keeps engine_common.cuh's init_env.
//
// Registers a thread (-Xptxas -v, CUDA 12.9; L = 8 without / with the
// observation / with the sample, then L = 1 the same), no spill and no
// stack frame at any geometry but the one-lane sampling build at 10x20 (an
// 8-byte frame, 4 bytes spilled) (tools/time_turbo_kernels.py --ptxas):
// 10x20 56 / 56 / 56, 96 / 96 / 96; 30x20 64 / 64 / 64, 119 / 128 / 128;
// 61x12 72 / 72 / 72, 128 / 128 / 128; 28x14 64 / 64 / 64, 96 / 96 / 96;
// 8x12 56 / 48 / 48, 64 / 64 / 72; 6x6 pieces at width 10 56 / 48 / 56,
// 80 / 80 / 80, at width 30 64 / 64 / 64, 128 / 128 / 118.  The four
// builds without the sample compile to the SASS they had before it was
// added (cuobjdump -sass, parameter offsets aside).
//
// Geometry is fixed at compile time by the TETRIS_* defines
// (engine_common.cuh, kernels.py:engine_defines), one library per geometry,
// each with six builds (L = 1 or 8, with or without the observation, and
// with the observation and the sample).
// The wrapper writes the new state to new buffers.  The RNG, the
// draws, the swap and the bit helpers are shared with the flagship engine's
// kernels (engine_common.cuh, unchanged by the band helpers).

#include <cstdint>
#include <cuda_runtime.h>

#include <algorithm>

#include "board_words.cuh"
#include "engine_common.cuh"
#include "sample_group.cuh"
#include "turbo_band.cuh"

using namespace engine;
using namespace sampling;

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
__device__ __forceinline__ void load_scalars(Env& e, const StatePtrs& p, int b, int B) {
  e.k0 = p.key[b];
  e.k1 = p.key[B + b];
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

__device__ __forceinline__ void store_scalars(const Env& e, const StatePtrs& p, int b, int B) {
  p.key[b] = e.k0;
  p.key[B + b] = e.k1;
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

__device__ __forceinline__ void load_env(Env& e, const StatePtrs& p, int b, int B) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) e.rows[h][j] = p.rows[(h * NW + j) * B + b];
  load_scalars(e, p, b, B);
}

__device__ __forceinline__ void store_env(const Env& e, const StatePtrs& p, int b, int B) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < NW; ++j) p.rows[(h * NW + j) * B + b] = e.rows[h][j];
  store_scalars(e, p, b, B);
}

constexpr int kThreads = 128;
constexpr int kFrame = HEIGHT * WIDTH;  // bytes of an observation

// One step of one env (a thread, or a group of L lanes on bands of its
// rows), then auto-reset.  The control flow is the same for every L: only
// the row helpers differ.  Returns the reward; sets done (before the
// reset) and n_lines.
template <int L, typename Rows_>
__device__ __forceinline__ float step_env(Env& e, Rows_& rows, int a, const StepParams& p,
                                          const uint32_t* packed, const int32_t* box,
                                          uint32_t (*scratch)[NW], bool& done, int& n_lines) {
  const bool uniform = p.uniform != 0;
  float reward = 0.0f;
  n_lines = 0;
  if (!e.game_over) {  // a finished game freezes, key and steps included
    // -- phase 1: the action's direct effect, tested against the pre-step rows
    if constexpr (L == 1) apply_action<false>(e, a, uniform, packed, box);
    else band_apply_action(e, rows, a, uniform, packed, box);
    // -- phase 2: gravity, then commit on rest or hard drop
    const PieceWord w1 = piece_word(packed, e.piece, e.rotation);
    HitMask hm1;
    if constexpr (L == 1) hm1 = hit_map(e.rows, w1, e.x);
    else hm1 = band_hit_map(rows, w1, e.x);
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
        int n;
        if constexpr (L == 1) {
          project(e.rows, w1, e.x, e.y + drop_from_map(hm1, e.y));
          n = clear_lines(e.rows, p.max_clear);
        } else {
          band_project(rows, w1, e.x, e.y + drop_from_map(hm1, e.y));
          n = band_clear_lines(rows, p.max_clear, scratch);
        }
        const int new_piece = queue_draw(e, uniform);
        const int sx = spawn_x(box, new_piece);
        bool over;
        if constexpr (L == 1) over = spawn_overlap(e.rows, piece_word(packed, new_piece, 0), sx);
        else over = band_spawn_overlap(rows, piece_word(packed, new_piece, 0), sx);
        const bool spawn_over = over || n > p.max_clear;
        reward = spawn_over ? p.r_game_over : static_cast<float>(n * n * WIDTH) + p.r_alife;
        e.piece = new_piece;
        e.rotation = 0;
        e.x = sx;
        e.y = 0;
        e.has_swapped = false;
        e.game_over = spawn_over;
        e.lines += n;
        n_lines = n;
      }
    }
    e.score = e.score + reward;
    e.steps += 1;
  }
  done = e.game_over;
  if (p.auto_reset && done) {
    init_env(e, e.k0, e.k1, uniform, box);
    if constexpr (L > 1) band_empty(rows);
  }
  return reward;
}

// L lanes an env (kThreads / L envs a block); with kObs the observation of
// the stored state is written to obs int8[B, HEIGHT, WIDTH], staged in the
// block's dynamic shared memory (kThreads / L frames) and stored with
// 16-byte words; with kSample (and kObs) the action is sampled from the
// logits of `smp` and written there with its log-prob.
template <int L, bool kObs, bool kSample = false>
__global__ void __launch_bounds__(kThreads) turbo_step_kernel(
    StatePtrs in, StatePtrs out, const int32_t* __restrict__ action, float* __restrict__ reward_out,
    uint8_t* __restrict__ done_out, int32_t* __restrict__ lines_out,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box,
    int8_t* __restrict__ obs, int B, StepParams p, SampleArgs smp) {
  static_assert(!kSample || kObs, "the sample is built with the observation only");
  constexpr int E = kThreads / L;  // envs a block
  extern __shared__ __align__(16) int8_t frames[];  // kObs: E frames of kFrame bytes
  __shared__ uint32_t scratch[L > 1 ? E : 1][HEIGHT][NW];  // the line clear's rows, a group each
  const int t = threadIdx.x / L;  // the env's slot in the block
  const int base = blockIdx.x * E;
  const int b = base + t;
  if (!kObs && b >= B) return;
  if (b < B) {
    Env e;
    int lines;
    bool done;
    float reward;
    int a;
    float log_prob = 0.0f;
    Draw<L> draw;  // kSample: the sample's first half, before the state's loads
    if constexpr (kSample) sample_draw<L>(draw, smp, b, threadIdx.x % L);
    else a = action[b];
    if constexpr (L == 1) {
      // one thread's whole sample before the state's loads: its sixteen
      // draws die here, and ptxas still issues the loads beside it
      if constexpr (kSample) a = sample_reduce<1>(draw, 0, 0u, log_prob);
      load_env(e, in, b, B);
      reward = step_env<1>(e, e.rows, a, p, packed, box, nullptr, done, lines);
      store_env(e, out, b, B);
      if constexpr (kObs) write_frame_rows<H>(e.rows, 0, e, packed, frames + t * kFrame);
    } else {
      Band<L> bd;
      bd.lane = threadIdx.x % L;
      bd.mask = (L == 32 ? 0xFFFFFFFFu : (1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
      load_scalars(e, in, b, B);
      load_band(bd, in.rows, b, B);
      if constexpr (kSample) a = sample_reduce<L>(draw, bd.lane, bd.mask, log_prob);
      reward = step_env<L>(e, bd, a, p, packed, box, scratch[t], done, lines);
      store_band(bd, out.rows, b, B);
      if (bd.lane == 0) store_scalars(e, out, b, B);
      if constexpr (kObs)
        write_frame_rows<Band<L>::R>(bd.rows, bd.row0(), e, packed, frames + t * kFrame);
    }
    if (L == 1 || threadIdx.x % L == 0) {
      reward_out[b] = reward;
      done_out[b] = done ? 1 : 0;
      lines_out[b] = lines;
      if constexpr (kSample) {
        smp.action[b] = a;
        smp.log_prob[b] = log_prob;
      }
    }
  }
  if constexpr (kObs) {
    __syncthreads();
    if (base < B) block_copy(obs + static_cast<long long>(base) * kFrame, frames,
                             min(E, B - base) * kFrame);
  }
}
// ---- turbo_init ------------------------------------------------------------
//
// A fresh batch: the rows tensor uint32[H, NW, B] holds one word per (h, j)
// across its B envs (the side walls, the bedrock), and each env's RNG chain
// gives its scalar fields.  The block's threads split in two: the env warps
// run one chain a thread, and the warps after them stream the block's share
// of the rows tensor as 16-byte words (four envs a store), their stores
// beside the chains.  Envs a block min(kInitEnvs, ceil(B / SMs)) rounded up
// to whole warps, so that a batch spreads over the SMs.

constexpr int kInitThreads = 256;            // threads a block of the init
constexpr int kInitEnvs = kInitThreads / 2;  // envs a block at most: half the warps stream

// Word seg of the rows' pattern: row h = seg / NW, word j = seg % NW (NW a
// constant, j taken by selects from the constant words).
__device__ __forceinline__ uint32_t init_row_word(uint32_t seg) {
  const uint32_t h = seg / NW, j = seg % NW;
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    if (j == static_cast<uint32_t>(k)) v = h < HEIGHT ? side_word(k) : full_word(k);
  return v;
}

// The block's share of the rows tensor, words [4 q, 4 q + 4) of chunk q for
// q in [q0, q1), from thread si of S: a chunk's four words share one row
// word where they lie in one (h, j) segment of B words, and a chunk across
// two (or, for B < 4, more) goes a word at a time.  A thread divides by B
// twice and then carries its chunk's segment and offset from chunk to
// chunk, so that its loop is a few adds a store.
__device__ __forceinline__ void stream_rows(uint32_t* rows, uint32_t B, uint32_t q0, uint32_t q1,
                                            int si, int S) {
  const uint32_t words = static_cast<uint32_t>(H * NW) * B;
  const uint32_t step = 4u * static_cast<uint32_t>(S), step_seg = step / B, step_off = step % B;
  uint32_t q = q0 + static_cast<uint32_t>(si);
  uint32_t seg = 4u * q / B, off = 4u * q - seg * B;  // chunk q's first word
  for (; q < q1; q += S) {
    if (off + 3u < B && 4u * q + 4u <= words) {
      const uint32_t v = init_row_word(seg);
      reinterpret_cast<uint4*>(rows)[q] = make_uint4(v, v, v, v);
    } else {
      for (uint32_t i = 4u * q; i < 4u * q + 4u && i < words; ++i) rows[i] = init_row_word(i / B);
    }
    seg += step_seg;
    off += step_off;
    if (off >= B) {
      off -= B;
      ++seg;
    }
  }
}

// next_bits as draw i (from 0) of a chain from key (k1:k0) sees it: the
// 64-bit counter (k1:k0) + (i + 1) * GOLDEN, so every draw can be mixed at
// once.
__device__ __forceinline__ uint32_t bits_at(uint64_t key, int i) {
  const uint64_t c = key + static_cast<uint64_t>(i + 1) * GOLDEN;
  return fmix32(static_cast<uint32_t>(c) ^ fmix32(static_cast<uint32_t>(c >> 32)));
}

__device__ __forceinline__ int randint_bits(uint32_t bits, uint32_t n) {
  return static_cast<int>(((bits >> 16) * n) >> 16);
}

// init_pieces from key (k0, k1), all but the spawn column: with NP <= 8 the
// bag is 4-bit entries of one word, the shuffle's NP - 1 draws are mixed at
// once and each swap is a few shifts and masks; the draws after it (a
// uniform queue, or a bag queue that outlasts one bag) keep init_pieces'
// order.  NP > 8 takes init_pieces itself.
__device__ __forceinline__ void init_chain(Env& e, uint32_t k0, uint32_t k1, bool uniform,
                                           const int32_t* box) {
  if constexpr (NP > 8) {
    init_pieces(e, k0, k1, uniform, box);
  } else {
    const uint64_t key = static_cast<uint64_t>(k1) << 32 | k0;
    uint32_t bag = 0x76543210u & static_cast<uint32_t>((uint64_t{1} << (4 * NP)) - 1u);
#pragma unroll
    for (int i = NP - 1; i > 0; --i) {  // ops/rng.py:shuffle's order, draw NP - 1 - i
      const int j = randint_bits(bits_at(key, NP - 1 - i), static_cast<uint32_t>(i + 1));
      const uint32_t d = ((bag >> (4 * i)) ^ (bag >> (4 * j))) & 15u;
      bag ^= d << (4 * i) | d << (4 * j);
    }
#pragma unroll
    for (int l = 0; l < NP; ++l) e.bag[l] = static_cast<int>((bag >> (4 * l)) & 15u);
    const uint64_t shuffled = key + static_cast<uint64_t>(NP - 1) * GOLDEN;
    e.k0 = static_cast<uint32_t>(shuffled);
    e.k1 = static_cast<uint32_t>(shuffled >> 32);
    e.bag_index = 0;
    if (!uniform && QS + 1 <= NP) {
      e.piece = e.bag[0];
#pragma unroll
      for (int i = 0; i < QS; ++i) e.queue[i] = e.bag[(1 + i) % NP];
      e.bag_index = QS + 1;
    } else if (uniform) {
      e.piece = randint_bits(bits_at(key, NP - 1), NP);
#pragma unroll
      for (int i = 0; i < QS; ++i) e.queue[i] = randint_bits(bits_at(key, NP + i), NP);
      const uint64_t drawn = key + static_cast<uint64_t>(NP + QS) * GOLDEN;
      e.k0 = static_cast<uint32_t>(drawn);
      e.k1 = static_cast<uint32_t>(drawn >> 32);
    } else {
      e.piece = draw(e, false);
#pragma unroll
      for (int i = 0; i < QS; ++i) e.queue[i] = draw(e, false);
    }
    e.rotation = 0;
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
}

// init for a block of up to E envs (kernels.py:turbo_init_shape), no
// block-wide barrier: the env warps read their keys (one 8-byte word an env
// from keys[B, 2], or the state's layout keys[2, B] with key_rows), run
// their chains and store the scalar fields, the spawn column from the box
// table by shuffle (no load in the chain); the other warps stream the
// block's share of the rows tensor.
__global__ void __launch_bounds__(kInitThreads) turbo_init_kernel(
    const uint32_t* __restrict__ keys, StatePtrs out, const int32_t* __restrict__ box, int B,
    int E, int uniform, int key_rows) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int base = blockIdx.x * E;
  const int n = min(E, B - base);
  const int env_warps = (n + 31) / 32;
  if (warp >= env_warps) {
    const uint32_t chunks = (static_cast<uint32_t>(H * NW) * B + 3) / 4;
    const uint32_t per = (chunks + gridDim.x - 1) / gridDim.x;
    const uint32_t q0 = min(chunks, blockIdx.x * per);
    stream_rows(out.rows, B, q0, min(chunks, q0 + per), t - 32 * env_warps,
                kInitThreads - 32 * env_warps);
    return;
  }
  const int i = t;  // the env's slot in the block
  const int b = base + i;
  uint32_t k0 = 0u, k1 = 0u;
  if (i < n) {
    if (key_rows) {
      k0 = keys[b];
      k1 = keys[B + b];
    } else {
      const uint2 k = __ldg(reinterpret_cast<const uint2*>(keys) + b);
      k0 = k.x;
      k1 = k.y;
    }
  }
  const int boxv = lane < NP ? __ldg(box + lane) : 0;
  Env e;
  init_chain(e, k0, k1, uniform != 0, box);
  e.x = PW / 2 - __shfl_sync(0xffffffffu, boxv, i < n ? e.piece : 0) / 2;  // spawn_x
  if (i < n) store_scalars(e, out, b, B);
}

template <int L, bool kObs, bool kSample>
int launch_step(const StatePtrs* in, const StatePtrs* out, const void* action, void* reward,
                void* done, void* lines, const void* packed, const void* box, void* obs, int B,
                const StepParams* params, const SampleArgs& smp, cudaStream_t stream) {
  constexpr int E = kThreads / L;
  constexpr int kStatic = (L > 1 ? E : 1) * HEIGHT * NW * 4;  // the line clear's scratch
  const int smem = kObs ? E * kFrame : 0;
  if (smem + kStatic > 48 * 1024) {  // past 48 KB in all, the dynamic part needs the attribute
    const cudaError_t err = cudaFuncSetAttribute(
        turbo_step_kernel<L, kObs, kSample>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  turbo_step_kernel<L, kObs, kSample><<<(B + E - 1) / E, kThreads, smem, stream>>>(
      *in, *out, static_cast<const int32_t*>(action), static_cast<float*>(reward),
      static_cast<uint8_t*>(done), static_cast<int32_t*>(lines),
      static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box),
      static_cast<int8_t*>(obs), B, *params, smp);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_lanes(const StatePtrs* in, const StatePtrs* out, const void* action, void* reward,
                 void* done, void* lines, const void* packed, const void* box, void* obs, int B,
                 const StepParams* params, const SampleArgs* sample, cudaStream_t stream) {
  if (sample != nullptr)
    return obs ? launch_step<L, true, true>(in, out, action, reward, done, lines, packed, box,
                                            obs, B, params, *sample, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  const SampleArgs none{};
  return obs ? launch_step<L, true, false>(in, out, action, reward, done, lines, packed, box, obs,
                                           B, params, none, stream)
             : launch_step<L, false, false>(in, out, action, reward, done, lines, packed, box,
                                            obs, B, params, none, stream);
}

}  // namespace

// lanes: 1 or 8 (kernels.py:step_lanes); obs: int8[B, HEIGHT, WIDTH] or null;
// sample: null, or (with obs) the logits and key to sample the action from,
// where `action` is then unused.
extern "C" int turbo_step_launch(const StatePtrs* in, const StatePtrs* out, const void* action,
                                 void* reward, void* done, void* lines, const void* packed,
                                 const void* box, void* obs, int B, int lanes,
                                 const StepParams* params, const SampleArgs* sample,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      return launch_lanes<1>(in, out, action, reward, done, lines, packed, box, obs, B, params,
                             sample, s);
    case 8:
      return launch_lanes<8>(in, out, action, reward, done, lines, packed, box, obs, B, params,
                             sample, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Envs a block of the init for a batch of B: kInitEnvs, or where B's envs
// give the card's SMs fewer than kInitEnvs each, as many as give every SM a
// block, rounded up to whole warps (a warp's field stores then start on
// 128-byte lines).
static int init_envs(int B) {
  const int per_sm = (B + sm_count() - 1) / sm_count();
  return std::min(kInitEnvs, (per_sm + 31) / 32 * 32);
}

// keys: uint32[B, 2] (mesh.batch_keys layout; 8-byte aligned), or with
// key_rows uint32[2, B] (TurboState.key); out's rows on a 16-byte boundary.
extern "C" int turbo_init_launch(const void* keys, const StatePtrs* out, const void* box, int B,
                                 int uniform, int key_rows, void* stream) {
  const int E = init_envs(B);
  turbo_init_kernel<<<(B + E - 1) / E, kInitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), *out, static_cast<const int32_t*>(box), B, E, uniform,
      key_rows);
  return static_cast<int>(cudaGetLastError());
}

// The init's shape for a batch of B: out = [envs a block, threads a block].
extern "C" int turbo_init_shape(int B, int* out) {
  out[0] = init_envs(B);
  out[1] = kInitThreads;
  return 0;
}
