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
// vmap, with every candidate outcome computed and selected.  Here an env
// branches.  The state is batch-leading: the id board int8[B, H, PW] (432
// bytes an env at 10x20, 912 at 30x20) and small per-env fields.
//
// The step runs a group of L lanes an env (L = 8 or 16, 16 envs a block;
// kernels.py:flagship_step_lanes picks L from B and the padded height), as
// the turbo engine's band builds (turbo_band.cuh): every lane runs the
// env's scalar logic the same way, so the RNG stream cannot diverge, and
// holds only a band of R = ceil(H / L) rows.
//   - The block's boards come into shared memory at an env stride chosen at
//     compile time (board_stride) so that the lanes' word reads of their
//     rows meet the fewest bank conflicts, every thread's loads issued
//     before its stores.  Each lane reads its env's ~100 bytes of fields
//     itself (the group's lanes read the same words, one request a warp):
//     a first version that staged them through shared memory, field by
//     field, coalesced, was slower on the card (PERF.md).
//   - A lane packs its band from 32-bit reads: each row's bytes are
//     funnel-shifted to the row's start and a byte compare and a multiply
//     turn four cells into four bits (pack_band), bit w - 32 j of word j of
//     the row; the rows below the band that a window reaches come from the
//     next lanes by shuffles.
//   - The hit maps, the line clear (any number of rows: the flagship engine
//     has no envelope) and the spawn test are turbo_band.cuh's, with the
//     flagship engine's piece lookup (piece_word_2d).
//   - On a lock each lane ADDS the piece's id to the cells of its own rows
//     (the JAX project adds), then rewrites its playfield rows: zeros for
//     the top n rows, else the kept row that lands there, read from the
//     step's input board in global memory with the id added again, so no
//     lane reads a row of shared memory that another lane writes; then its
//     pad columns and bottom rows become bedrock.  Auto-reset empties its
//     rows.
//   - Lane 0 stores the env's fields; the block stores the boards
//     coalesced.
//   - With the sample (PPO's rollout on this engine: kSample, at L = 8 and
//     16), the launch also takes the tail of rl/ppo.py:policy_step that
//     ppo_sample.cu runs on its own (sample_group.cuh): lane l draws action
//     l & 7 from the policy's logits before the fields' loads and the
//     boards' staging, the argmax and log-sum-exp shuffles among the 8
//     lanes of its eighth of the group run after the barrier, every lane
//     steps with lane 0's action, and lane 0 writes the action and its
//     log-prob; every output is bit-equal to sample_actions_plain and
//     step_plain, and the log-prob to ppo_sample.cu's.  It adds 40 bytes an
//     env (32 of logits read, 8 written) and saves ppo_sample's launch.
//
// Bound on this card: bytes.  A step reads the board and ~80 bytes of
// other state and the action, and writes the same plus reward, done and
// lines: ~1.06 KB an env at 10x20 (0.16 us at B = 512, 21 us at B = 65536
// at 3.35 TB/s), ~2.03 KB at 30x20.  The integer work per env (a few
// hundred instructions, more on a lock) is below that at full occupancy.
// flagship_init writes a fresh state (~0.53 KB an env at 10x20): the
// boards as a stream of 16-byte words of their constant pattern, computed
// where they are stored, beside one RNG chain a thread an env, up to 256
// envs a block and no block-wide barrier; a full warp's row fields (bag,
// queue, holder) go out coalesced through its tile in shared memory.
// flagship_observe_board reads the playfield rows and writes the cropped
// int8[HEIGHT, WIDTH] frame: the bound counts the 200 playfield cells in,
// 17 bytes of fields and 200 out an env at 10x20; it reads 360 bytes of
// rows, the padding columns with them.  A warp takes one env while the
// batch gives the SMs at most 16 warps each, else 1-4 (kObsWarpEnvs), with
// no block-wide barrier: the rows in whole words, an env's piece work once,
// its rows and frames staged in the warp's own shared memory and stored in
// 16-byte words; warps a block min(8, the batch's warps / SMs), so that the
// evaluation's 512 envs spread over the card.
//
// Geometry is fixed at compile time by the TETRIS_* defines
// (engine_common.cuh, kernels.py:engine_defines), one library per
// geometry with the four step builds (L = 8 or 16, with or without the
// sample).  What other geometries change here:
//   - BOARD = H * PW need not be a multiple of 16 (648 bytes at 28x14, 924
//     for the 6x6 pieces at 30x16): the init's words are those of the whole
//     board tensor, each taking its pattern from its offset into a board,
//     and only the tensor's last word can be ragged; a band build stages
//     its boards in 16-, 4- or 1-byte words, and the observation reads
//     them in 16-, 8-, 4-, 2- or 1-byte words, the widest that BOARD is a
//     multiple of (board_words.cuh:word_bytes); the observation's frames
//     of OBS bytes are stored in 16-byte words from the first 16-byte
//     boundary on;
//   - the boards of a block live in dynamic shared memory: the band
//     builds' 16 stride-padded boards and line-clear rows (BandSmem), the
//     observation's rows and frames (ObsBuild<E>::WARP_SMEM a warp: 2288
//     bytes at 10x20 with four envs, 592 with one), opted in above 48 KB;
//     the init keeps only its row-field tiles.  engine_defines keeps
//     BOARD <= 3072 for the flagship sources, the size up to which the
//     shared memory of the band builds, the observation, grouped_flagship
//     and render_rgb84 is laid out and held by their static_asserts.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "board_words.cuh"
#include "engine_common.cuh"
#include "sample_group.cuh"
#include "turbo_band.cuh"

using namespace engine;
using namespace sampling;

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
constexpr int kInitThreads = 256;  // threads a block of the init, and most envs
constexpr int kInitWarps = kInitThreads / 32;
// The init's board stream: the pattern of 16-byte words repeats every
// kPeriod words (lcm(BOARD, 16) bytes); a 16-byte word touches at most
// kWordRows rows.  An env's row fields (bag, queue, holder) are kRowInts
// words, staged in its warp's tile of kInitSmem / kInitWarps bytes.
__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }
constexpr int kPeriod = BOARD / gcd(BOARD, 16);
constexpr int kWordRows = 15 / PW + 2;
constexpr int kRowInts = NP + QS + 2 * HS;
constexpr int kInitSmem = kInitThreads * kRowInts * 4;

// The observation's shape: each env's playfield rows (PLAY bytes) read as
// NIW words of WI bytes, kObsWarpEnvs envs a warp for a large batch (of
// 1-4, the count whose words fill the warp's rounds of 32 lanes best within
// six rounds, the fewer on a tie: 4 at 10x20, 2 at 30x20, 3 at 61x12, 1 at
// 28x14 and for the 6x6 pieces at 30x16) and one for a small one, at most
// kObsWarps warps a block.
constexpr int OBS = HEIGHT * WIDTH;  // bytes of a cropped frame: 200 at 10x20
constexpr int PLAY = HEIGHT * PW;    // bytes of the playfield rows: 360 at 10x20
constexpr int WI = word_bytes(BOARD);
constexpr int NIW = (PLAY + WI - 1) / WI;  // 23 at 10x20; never past the board's end

__host__ __device__ constexpr int obs_warp_envs() {
  int best = 1, best_words = 0, best_lanes = 1;
  for (int e = 1; e <= 4; ++e) {
    const int words = e * NIW, lanes = 32 * ((words + 31) / 32);
    if (lanes <= 6 * 32 && words * best_lanes > best_words * lanes)
      best = e, best_words = words, best_lanes = lanes;
  }
  return best;
}

constexpr int kObsWarpEnvs = obs_warp_envs();
constexpr int kObsWarps = 8;
// One env a warp while the batch gives the SMs at most this many warps
// each: there a shorter chain a warp beats fuller lanes (PERF.md).
constexpr int kObsOneEnvWarpsPerSM = 16;
constexpr int SPLAY = NIW * WI;  // bytes of an env's staged playfield rows: 368 at 10x20

// The build of E envs a warp (1 or kObsWarpEnvs): a lane's rounds of words,
// whether they are all loaded up front, and a warp's shared memory: its
// envs' playfield rows, then its frames (15 bytes more, so that they lie as
// aligned as in the output).
template <int E>
struct ObsBuild {
  static constexpr int ROUNDS = (E * NIW + 31) / 32;
  static constexpr bool HELD = ROUNDS <= 6;
  static constexpr int ROWS_SMEM = (E * SPLAY + 15) / 16 * 16;
  static constexpr int WARP_SMEM = ROWS_SMEM + (E * OBS + 15 + 15) / 16 * 16;
  static_assert(kObsWarps * WARP_SMEM <= 227 * 1024, "shared memory of a block");
};
// a frame row's bytes move in words of G bytes: the widest of 4, 2 and 1
// that a row's start in the board and in the frame are multiples of (2 at
// 10x20 and 30x20, 1 at 61x12, 4 at 28x14)
constexpr int G = (PW % 4 == 0 && PAD % 4 == 0 && WIDTH % 4 == 0) ? 4
                  : (PW % 2 == 0 && PAD % 2 == 0 && WIDTH % 2 == 0) ? 2 : 1;
using Granule = std::conditional_t<G == 4, uint32_t, std::conditional_t<G == 2, uint16_t, uint8_t>>;

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

// create_board's cell c of a board: 1 on the bedrock (the pad columns and
// the rows below the playfield), 0 inside.
__device__ __forceinline__ int8_t board_cell(int c) {
  const int r = c / PW, w = c % PW;
  return (r >= HEIGHT || w < PAD || w >= PAD + WIDTH) ? 1 : 0;
}

// The 16 bytes of create_board's boards laid end to end from byte o of a
// board (0 <= o < BOARD): byte i is cell (o + i) mod BOARD.  The word's
// playfield cells are bits, an interval of each playfield row that it
// touches (row r / PW of the stream is row r mod H of a board, BOARD being
// H rows), and each 4 bits become a 32-bit lane of bytes (expand4).
__device__ __forceinline__ uint4 board_word(int o) {
  const int r0 = o / PW;
  uint32_t play = 0u;
#pragma unroll
  for (int k = 0; k < kWordRows; ++k) {
    const int r = r0 + k, at = r * PW + PAD - o;  // the row's first playfield cell, from o
    const int lo = max(at, 0), hi = min(at + WIDTH, 16);
    if (r % H < HEIGHT && lo < hi) play |= (0xFFFFu >> (16 - hi)) & ~((1u << lo) - 1u);
  }
  const uint32_t rock = ~play;
  return make_uint4(expand4(rock & 15u), expand4((rock >> 4) & 15u), expand4((rock >> 8) & 15u),
                    expand4((rock >> 12) & 15u));
}

// The block's words of the board tensor from thread si of S: the words
// whose first byte lies in the block's boards, si, si + S, ...; each is
// computed where it is stored (one word throughout where S is a multiple
// of the period), the tensor's ragged last word byte by byte where
// B * BOARD is no multiple of 16.
__device__ __forceinline__ void stream_board(int8_t* board, long long base, int n, int B, int si, int S) {
  const bool fixed = S % kPeriod == 0;
  const int step = (16 * S) % BOARD;
  const long long total = static_cast<long long>(B) * BOARD;
  const long long w0 = (base * BOARD + 15) / 16;
  const int words = static_cast<int>(((base + n) * BOARD + 15) / 16 - w0);
  int o = static_cast<int>((16 * (w0 + si)) % BOARD);
  const uint4 first = board_word(o);
  uint4* dst = reinterpret_cast<uint4*>(board);
  for (int i = si; i < words; i += S) {
    const long long w = w0 + i;
    if (16 * w + 16 <= total) {
      dst[w] = fixed ? first : board_word(o);
    } else {  // the tensor's ragged last word
      for (int j = 0; j < total - 16 * w; ++j) board[16 * w + j] = board_cell((o + j) % BOARD);
    }
    o += step;
    if (o >= BOARD) o -= BOARD;
  }
}

// count words from a warp's tile to dst, in 16-byte words where dst lies on
// a 16-byte boundary and count is a multiple of 4 (the tile's rows of each
// field start on one: 32 * N words from the tile's start).
__device__ __forceinline__ void store_tile(int32_t* dst, const int32_t* tile, int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0 && (count & 3) == 0) {
    for (int f = lane; f < count / 4; f += 32)
      reinterpret_cast<uint4*>(dst)[f] = reinterpret_cast<const uint4*>(tile)[f];
  } else {
    for (int f = lane; f < count; f += 32) dst[f] = tile[f];
  }
}

// A warp's m envs from base b0: the lanes load their keys and the box
// table, run their RNG chains (the bag's shuffle and the queue's draws) and
// store their fields, the spawn column from the box table by shuffle (no
// load in the chain).  A full warp puts its row fields (bag, queue,
// holder) through its tile so that they go out coalesced, m * N
// consecutive words each; a part-full one, the few envs of a small batch,
// stores them as they are.
__device__ __forceinline__ void init_warp(const uint32_t* keys, const FlagshipPtrs& out, const int32_t* box,
                                          int B, long long b0, int m, int lane, bool uniform,
                                          int32_t* tile) {
  uint2 k = make_uint2(0u, 0u);
  if (lane < m) k = __ldg(reinterpret_cast<const uint2*>(keys) + b0 + lane);
  const int boxv = lane < NP ? __ldg(box + lane) : 0;
  Env e;
  int piece = 0;
  if (lane < m) {
    init_pieces(e, k.x, k.y, uniform, box);
    piece = e.piece;
  }
  const int x = PW / 2 - __shfl_sync(0xffffffffu, boxv, piece) / 2;  // spawn_x
  const bool staged = m == 32;
  if (lane < m) {
    const long long b = b0 + lane;
    out.key[b] = e.k0;
    out.key[B + b] = e.k1;
    out.piece[b] = e.piece;
    out.rotation[b] = e.rotation;
    out.x[b] = x;
    out.y[b] = e.y;
    out.bag_index[b] = e.bag_index;
    out.holder_count[b] = e.holder_count;
    out.has_swapped[b] = e.has_swapped ? 1 : 0;
    out.game_over[b] = e.game_over ? 1 : 0;
    out.score[b] = e.score;
    out.lines[b] = e.lines;
    out.steps[b] = e.steps;
    int32_t* bag = staged ? tile + lane * NP : out.bag + b * NP;
    int32_t* queue = staged ? tile + 32 * NP + lane * QS : out.queue + b * QS;
    int32_t* hp = staged ? tile + 32 * (NP + QS) + lane * HS : out.holder_piece + b * HS;
    int32_t* hr = staged ? tile + 32 * (NP + QS + HS) + lane * HS : out.holder_rotation + b * HS;
#pragma unroll
    for (int i = 0; i < NP; ++i) bag[i] = e.bag[i];
#pragma unroll
    for (int i = 0; i < QS; ++i) queue[i] = e.queue[i];
#pragma unroll
    for (int i = 0; i < HS; ++i) {
      hp[i] = e.holder_piece[i];
      hr[i] = e.holder_rotation[i];
    }
  }
  if (!staged) return;
  __syncwarp();  // the warp's tile of row fields
  store_tile(out.bag + b0 * NP, tile, 32 * NP, lane);
  store_tile(out.queue + b0 * QS, tile + 32 * NP, 32 * QS, lane);
  store_tile(out.holder_piece + b0 * HS, tile + 32 * (NP + QS), 32 * HS, lane);
  store_tile(out.holder_rotation + b0 * HS, tile + 32 * (NP + QS + HS), 32 * HS, lane);
}

// init_state for a block of up to E envs (kernels.py:flagship_init_shape:
// E = min(kInitThreads, ceil(B / SMs)), so that a batch spreads over every
// SM), kInitThreads threads, no block-wide barrier.  The board tensor is B
// copies of one pattern known at compile time: threads stream their share
// of its 16-byte words (stream_board), and the warps of the block's n envs
// each init their envs (init_warp).  Where the envs leave two warps or more,
// those warps stream while the env warps run their chains; else every
// thread streams first, its stores draining while the chains run.
__global__ void __launch_bounds__(kInitThreads) flagship_init_kernel(
    const uint32_t* __restrict__ keys, FlagshipPtrs out, const int32_t* __restrict__ box, int B,
    int E, int uniform) {
  extern __shared__ int32_t tiles[];  // 32 * kRowInts words a warp
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long base = static_cast<long long>(blockIdx.x) * E;
  const int n = static_cast<int>(min(static_cast<long long>(E), B - base));
  const int env_warps = (n + 31) / 32;
  const int first = env_warps <= kInitWarps - 2 ? 32 * env_warps : 0;  // the first streaming thread
  const int avail = kInitThreads - first;
  const int S = avail >= kPeriod ? avail / kPeriod * kPeriod : avail;  // a multiple of the period where it fits
  if (first == 0 && t < S) stream_board(out.board, base, n, B, t, S);
  if (warp < env_warps)
    init_warp(keys, out, box, B, base + 32 * warp, min(32, n - 32 * warp), lane, uniform != 0,
              tiles + warp * 32 * kRowInts);
  else if (first > 0 && t - first < S)
    stream_board(out.board, base, n, B, t - first, S);
}

// observe_board: occupancy 0/1 with the active piece ADDED as -1 unless the
// game is over, cropped to the playfield.  A warp takes kObsWarpEnvs envs:
// lane l + 32 k loads word l + 32 k of the envs' playfield rows laid end to
// end (the rows the crop keeps, in the board's widest words: 16 bytes at
// 10x20, 30x20 and 61x12), lane e < kObsWarpEnvs computes env e's piece
// word (from the packed table held across the warp, board_words.cuh:
// LaneTable) and clamped window once and the lanes take them by shuffle; each
// lane makes its word's output bytes four at a time (__vcmpgts4, __vsub4)
// and stores the word into the warp's rows in shared memory; after
// __syncwarp a lane a frame row copies its WIDTH bytes from column PAD in
// words of G bytes into the warp's frames (putting each cell there from its
// word's lane, a byte at a time, was slower than the one-thread-a-row
// kernel it replaces: PERF.md); after __syncwarp the warp stores its
// frames, contiguous in the output, in 16-byte words.
template <int E>
__global__ void __launch_bounds__(32 * kObsWarps) flagship_observe_board_kernel(
    const int8_t* __restrict__ board, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const int32_t* __restrict__ xs,
    const int32_t* __restrict__ ys, const uint8_t* __restrict__ game_over,
    const uint32_t* __restrict__ packed, int8_t* __restrict__ out, int B) {
  extern __shared__ __align__(16) int8_t obs_s[];  // ObsBuild<E>::WARP_SMEM bytes a warp
  constexpr unsigned kAll = 0xffffffffu;
  using Build = ObsBuild<E>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = (blockIdx.x * (blockDim.x >> 5) + warp) * E;  // the warp's first env
  if (e0 >= B) return;  // the whole warp
  const int n = min(E, B - e0);

  // slot l + 32 k: word w of env e; loaded up front where they fit in
  // registers (Build::HELD), else a round at a time
  auto load = [&](int k) {
    const int e = (lane + 32 * k) / NIW, w = (lane + 32 * k) % NIW;
    return load_word<WI>(board + static_cast<size_t>(e0 + e) * BOARD + w * WI);
  };
  Word<WI> in[Build::HELD ? Build::ROUNDS : 1];
  if constexpr (Build::HELD) {
#pragma unroll
    for (int k = 0; k < Build::ROUNDS; ++k)
      if ((lane + 32 * k) / NIW < n) in[k] = load(k);
  }
  // env lane e < n: env e's piece word and clamped window, the piece word
  // by shuffles from the packed table held across the warp
  LaneTable<NP * 4 * TW> tpacked;
  tpacked.load(packed, lane);
  int pc = -1, rot = 0, win = 0;  // win: the clamped window, x | y << 8
  if (lane < n) {
    const int b = e0 + lane;
    // every field loaded at once: a piece read only once game_over says so
    // waits on a second round trip (a third of the time at 65536, PERF.md)
    const int x = xs[b], y = ys[b], p = piece[b], r = rotation[b];
    const bool over = game_over[b] != 0;
    pc = over ? -1 : p;
    rot = r;
    win = clamp_start(x, PW - S, PW) | clamp_start(y, H - S, H) << 8;
  }
  const PieceWord word = piece_word_lanes(tpacked, pc, rot);

  const size_t o0 = static_cast<size_t>(e0) * OBS;  // the warp's frames in the output
  const int off = static_cast<int>((reinterpret_cast<uintptr_t>(out) + o0) & 15u);
  int8_t* rows = obs_s + warp * Build::WARP_SMEM;     // the envs' playfield rows, SPLAY bytes each
  int8_t* frames = rows + Build::ROWS_SMEM + off;     // as aligned as out + o0
#pragma unroll
  for (int k = 0; k < Build::ROUNDS; ++k) {
    const int e = (lane + 32 * k) / NIW, i0 = (lane + 32 * k) % NIW * WI;
    const int src = min(e, E - 1);
    PieceWord pw;
#pragma unroll
    for (int t = 0; t < TW; ++t) pw.w[t] = __shfl_sync(kAll, word.w[t], src);
    const int wn = __shfl_sync(kAll, win, src);
    if (e < n) {
      Word<WI> v;
      if constexpr (Build::HELD) v = in[k];
      else v = load(k);
      const uint32_t pb = piece_bits<WI>(pw, wn & 0xFF, wn >> 8, i0);
#pragma unroll
      for (int g = 0; g < Word<WI>::N; ++g)
        v.v[g] = __vsub4(__vcmpgts4(v.v[g], 0u) & 0x01010101u, bit_bytes(pb, g));
      store_word<WI>(rows + e * SPLAY + i0, v);
    }
  }
  __syncwarp();
  // the crop: a frame row a lane, WIDTH bytes from column PAD of its row
  for (int item = lane; item < n * HEIGHT; item += 32) {
    const int e = item / HEIGHT, r = item % HEIGHT;
    const Granule* from = reinterpret_cast<const Granule*>(rows + e * SPLAY + r * PW + PAD);
    Granule* to = reinterpret_cast<Granule*>(frames + e * OBS + r * WIDTH);
#pragma unroll
    for (int c = 0; c < WIDTH / G; ++c) to[c] = from[c];
  }
  __syncwarp();
  // n * OBS bytes: up to the first 16-byte boundary, 16-byte words, the tail
  int8_t* dst = out + o0;
  const int nbytes = n * OBS;
  const int lead = min((16 - off) & 15, nbytes);
  const int words = (nbytes - lead) / 16;
  for (int t = lane; t < lead; t += 32) dst[t] = frames[t];
  for (int q = lane; q < words; q += 32)
    reinterpret_cast<uint4*>(dst + lead)[q] = reinterpret_cast<const uint4*>(frames + lead)[q];
  for (int t = lead + 16 * words + lane; t < nbytes; t += 32) dst[t] = frames[t];
}

constexpr int kBandEnvs = 16;  // envs a block of a band build (16 * L threads)

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// The env stride of a band build's boards in shared memory, in bytes: of
// the eight multiples of 16 from BOARD (their word counts cover every
// residue mod 32 that a 16-byte multiple has), the one whose first word
// reads of a row (pack_band: lane l of the warp's 32 / L envs at row
// l * R + r, every r) meet the fewest bank conflicts.
__host__ __device__ constexpr int board_stride(int L) {
  const int R = (H + L - 1) / L;
  int best = 0, best_cost = 1 << 30;
  for (int c = 0; c < 8; ++c) {
    const int es = align16(BOARD) + 16 * c;
    int cost = 0;
    for (int r = 0; r < R; ++r) {
      int count[32] = {};
      for (int g = 0; g < 32 / L; ++g)
        for (int l = 0; l < L; ++l)
          if (l * R + r < H) ++count[((g * es + (l * R + r) * PW) / 4) % 32];
      int worst = 0;
      for (int k = 0; k < 32; ++k) worst = count[k] > worst ? count[k] : worst;
      cost += worst;
    }
    if (cost < best_cost) {
      best_cost = cost;
      best = es;
    }
  }
  return best;
}

// Dynamic shared memory of a band build, in bytes: the boards (a word of
// slack past the last, which pack_band's last funnel read reaches), then
// the line clear's rows of each group.
template <int L>
struct BandSmem {
  static constexpr int ES = board_stride(L);
  static constexpr int BITS = align16(kBandEnvs * ES + 16);
  static constexpr int BYTES = BITS + kBandEnvs * HEIGHT * NW * 4;
  static_assert(BYTES <= 227 * 1024, "shared memory of a block");
};

// The block's n boards, global (contiguous, 16-byte aligned: a block starts
// at env 16k) <-> shared at env stride ES, in the widest of 16-, 4- or
// 1-byte words that BOARD is a multiple of.  Inward, a thread issues the
// loads of up to 8 words before it stores them.
template <int L, int ES>
__device__ __forceinline__ void stage_boards_in(const int8_t* global, int8_t* shared, int n) {
  constexpr int U = BOARD % 16 == 0 ? 16 : (BOARD % 4 == 0 ? 4 : 1);
  using W = std::conditional_t<U == 16, uint4, std::conditional_t<U == 4, uint32_t, uint8_t>>;
  constexpr int PER = BOARD / U;  // words a board
  constexpr int T = kBandEnvs * L, IT = (kBandEnvs * PER + T - 1) / T, CHUNK = 8;
  const W* g = reinterpret_cast<const W*>(global);
#pragma unroll
  for (int c = 0; c < IT; c += CHUNK) {
    W v[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = threadIdx.x + (c + j) * T;
      if (c + j < IT && i < n * PER) v[j] = g[i];
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int i = threadIdx.x + (c + j) * T;
      if (c + j < IT && i < n * PER) reinterpret_cast<W*>(shared + (i / PER) * ES)[i % PER] = v[j];
    }
  }
}

template <int ES>
__device__ __forceinline__ void stage_boards_out(int8_t* global, const int8_t* shared, int n) {
  constexpr int U = BOARD % 16 == 0 ? 16 : (BOARD % 4 == 0 ? 4 : 1);
  using W = std::conditional_t<U == 16, uint4, std::conditional_t<U == 4, uint32_t, uint8_t>>;
  constexpr int PER = BOARD / U;
  W* g = reinterpret_cast<W*>(global);
  for (int i = threadIdx.x; i < n * PER; i += blockDim.x)
    g[i] = reinterpret_cast<const W*>(shared + (i / PER) * ES)[i % PER];
}

// pack_board on the lane's band: row h's PW id bytes are read as aligned
// words from the env's board in shared memory, funnel-shifted to the row's
// start, and each word's four signed bytes > 0 become four bits (a byte
// compare, then a multiply that gathers the four 0/1 bytes into a nibble).
template <int L>
__device__ __forceinline__ void pack_band(Band<L>& bd, const int8_t* board) {
  constexpr int NQ = (PW + 3) / 4;  // words of a row
  const uint32_t* w = reinterpret_cast<const uint32_t*>(board);
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
#pragma unroll
    for (int j = 0; j < NW; ++j) bd.rows[r][j] = 0u;
    if (h < H) {
      const int o = h * PW, a = o >> 2, sh = (o & 3) * 8;
      uint32_t lo = w[a];
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        const uint32_t hi = w[a + k + 1];
        const uint32_t pos = __vcmpgts4(__funnelshift_r(lo, hi, sh), 0u) & 0x01010101u;
        lo = hi;
        bd.rows[r][(4 * k) / 32] |= (((pos * 0x00204081u) >> 21) & 0xFu) << ((4 * k) % 32);
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) bd.rows[r][j] &= full_word(j);
    }
  }
}

// stamp_ids on the lane's band: the piece's id ADDED (int8 wrap) under its
// cells in the rows the lane holds.
template <int L>
__device__ __forceinline__ void band_stamp_ids(int8_t* board, const Band<L>& bd,
                                               const PieceWord& word, int xc, int yc, int id) {
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r, i = h - yc;
    if (h < H && i >= 0 && i < S) {
      const uint32_t row = piece_row(word, i);
      for (int j = 0; j < S; ++j) {
        if ((row >> j) & 1u) {
          int8_t& c = board[h * PW + xc + j];
          c = static_cast<int8_t>(c + id);
        }
      }
    }
  }
}

// compact_ids and the re-pad of _commit on the lane's band.  With n full
// rows, playfield row d < n becomes zeros and row d >= n takes the kept row
// s that lands on it, the one with HEIGHT - d kept rows at or below it.  A
// row it takes is read from the step's input board in global memory with
// the piece's id added again, so no lane reads a row of shared memory that
// another lane writes.  Then the pad columns and the bottom rows become
// bedrock.
template <int L>
__device__ __forceinline__ void band_commit_ids(int8_t* board, const int8_t* in_board,
                                                const Band<L>& bd, FillMask full, int n,
                                                const PieceWord& word, int xc, int yc, int id) {
  const FillMask kept = ~full & (~FillMask{0} >> (8 * sizeof(FillMask) - HEIGHT));
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
    if (h >= H) continue;
    int8_t* dst = board + h * PW;
    if (h >= HEIGHT) {
      for (int w = 0; w < PW; ++w) dst[w] = 1;
      continue;
    }
    if (n > 0) {
      if (h < n) {
        for (int w = PAD; w < PAD + WIDTH; ++w) dst[w] = 0;
      } else {
        int s = h;
        while (popcount(kept >> s) < HEIGHT - h) --s;
        if (s != h) {
          const int8_t* src = in_board + s * PW;
          const int i = s - yc;
          const uint32_t prow = (i >= 0 && i < S) ? piece_row(word, i) : 0u;
          for (int w = PAD; w < PAD + WIDTH; ++w) {
            const int j = w - xc;
            const bool on = j >= 0 && j < S && ((prow >> j) & 1u);
            dst[w] = static_cast<int8_t>(src[w] + (on ? id : 0));
          }
        }
      }
    }
    for (int w = 0; w < PAD; ++w) {
      dst[w] = 1;
      dst[PAD + WIDTH + w] = 1;
    }
  }
}

// create_board's cells (board_cell) on the lane's band.
template <int L>
__device__ __forceinline__ void band_empty_ids(int8_t* board, const Band<L>& bd) {
#pragma unroll
  for (int r = 0; r < Band<L>::R; ++r) {
    const int h = bd.row0() + r;
    if (h < H)
      for (int w = 0; w < PW; ++w)
        board[h * PW + w] = (h >= HEIGHT || w < PAD || w >= PAD + WIDTH) ? 1 : 0;
  }
}

// L lanes an env, kBandEnvs envs a block: the boards come into shared
// memory coalesced, each lane packs its band, the group runs the step with
// turbo_band.cuh's helpers, lane 0 stores the env's fields, and the block
// stores the boards coalesced.  With kSample the action is sampled from the
// logits of `smp` (sample_group.cuh) and written there with its log-prob:
// each lane's draw is issued before the fields' loads and the boards'
// staging, and the group's reductions run after the barrier.
template <int L, bool kSample>
__global__ void __launch_bounds__(kBandEnvs * L) flagship_step_band_kernel(
    FlagshipPtrs in, FlagshipPtrs out, const int32_t* __restrict__ action,
    float* __restrict__ reward_out, uint8_t* __restrict__ done_out, int32_t* __restrict__ lines_out,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box,
    const int32_t* __restrict__ ids, int B, FlagshipParams p, SampleArgs smp) {
  using Smem = BandSmem<L>;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* boards = reinterpret_cast<int8_t*>(smem);
  auto bits = reinterpret_cast<uint32_t(*)[HEIGHT][NW]>(smem + Smem::BITS);
  const int base = blockIdx.x * kBandEnvs;
  const int n = min(kBandEnvs, B - base);
  const int t = threadIdx.x / L;
  const int b = base + t;
  // every lane of a group reads its env's fields (the same words: one
  // request a warp), issued beside the boards' loads
  Env e;
  int a = 0;
  Draw<L> draw;  // kSample: the sample's first half, before the state's loads
  if (t < n) {
    if constexpr (kSample) sample_draw<L>(draw, smp, b, threadIdx.x % L);
    load_env(e, in, b, B);
    if constexpr (!kSample) a = action[b];
  }
  stage_boards_in<L, Smem::ES>(in.board + static_cast<size_t>(base) * BOARD, boards, n);
  __syncthreads();

  if (t < n) {
    const bool uniform = p.uniform != 0;
    int8_t* bd_ids = boards + t * Smem::ES;
    Band<L> bd;
    bd.lane = threadIdx.x % L;
    bd.mask = (L == 32 ? 0xFFFFFFFFu : (1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
    pack_band(bd, bd_ids);
    band_load_below(bd);
    float log_prob = 0.0f;
    if constexpr (kSample) a = sample_reduce<L>(draw, bd.lane, bd.mask, log_prob);
    float reward = 0.0f;
    int lines = 0;

    if (!e.game_over) {  // a finished game freezes: the input state, reward 0
      // -- phase 1: the action's direct effect, tested against the pre-step rows
      band_apply_action<L, true>(e, bd, a, uniform, packed, box);
      // -- phase 2: gravity, then commit on rest or hard drop
      const PieceWord w1 = piece_word_2d(packed, e.piece, e.rotation);
      const HitMask hm1 = band_hit_map(bd, w1, e.x);
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
          const int id = piece_entry(ids, e.piece);
          const int xc = clamp_start(e.x, PW - S, PW), yc = clamp_start(y_f, H - S, H);
          band_stamp_ids(bd_ids, bd, w1, xc, yc, id);
          band_project(bd, w1, e.x, y_f);
          FillMask full = 0;
          const int nl = band_clear_lines(bd, HEIGHT, bits[t], &full);  // any number of rows
          band_commit_ids(bd_ids, in.board + static_cast<size_t>(b) * BOARD, bd, full, nl, w1, xc,
                          yc, id);
          const int new_piece = queue_draw(e, uniform);
          const int sx = spawn_x(box, new_piece);
          const bool spawn_over = band_spawn_overlap(bd, piece_word_2d(packed, new_piece, 0), sx);
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
      band_empty_ids(bd_ids, bd);
    }
    if (bd.lane == 0) {
      store_env(e, out, b, B);
      reward_out[b] = reward;
      done_out[b] = done ? 1 : 0;
      lines_out[b] = lines;
      if constexpr (kSample) {
        smp.action[b] = a;
        smp.log_prob[b] = log_prob;
      }
    }
  }
  __syncthreads();
  stage_boards_out<Smem::ES>(out.board + static_cast<size_t>(base) * BOARD, boards, n);
}

// Opts a kernel in to more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  done = true;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}


template <int L, bool kSample>
int launch_band(const FlagshipPtrs* in, const FlagshipPtrs* out, const void* action, void* reward,
                void* done, void* lines, const void* packed, const void* box, const void* ids,
                int B, const FlagshipParams* params, const SampleArgs& smp, cudaStream_t stream) {
  constexpr int smem = BandSmem<L>::BYTES;
  static bool opted = false;
  if (const cudaError_t err = allow_smem(flagship_step_band_kernel<L, kSample>, smem, opted))
    return err;
  flagship_step_band_kernel<L, kSample>
      <<<(B + kBandEnvs - 1) / kBandEnvs, kBandEnvs * L, smem, stream>>>(
          *in, *out, static_cast<const int32_t*>(action), static_cast<float*>(reward),
          static_cast<uint8_t*>(done), static_cast<int32_t*>(lines),
          static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(box),
          static_cast<const int32_t*>(ids), B, *params, smp);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_lanes(const FlagshipPtrs* in, const FlagshipPtrs* out, const void* action, void* reward,
                 void* done, void* lines, const void* packed, const void* box, const void* ids,
                 int B, const FlagshipParams* params, const SampleArgs* sample,
                 cudaStream_t stream) {
  if (sample != nullptr)
    return launch_band<L, true>(in, out, action, reward, done, lines, packed, box, ids, B, params,
                                *sample, stream);
  const SampleArgs none{};
  return launch_band<L, false>(in, out, action, reward, done, lines, packed, box, ids, B, params,
                               none, stream);
}

}  // namespace

// lanes: 8 or 16 lanes an env (kernels.py:FLAGSHIP_LANES,
// flagship_step_lanes); sample: null, or the logits and key to sample the
// action from, where `action` is then unused.
extern "C" int flagship_step_launch(const FlagshipPtrs* in, const FlagshipPtrs* out,
                                    const void* action, void* reward, void* done, void* lines,
                                    const void* packed, const void* box, const void* ids, int B,
                                    int lanes, const FlagshipParams* params,
                                    const SampleArgs* sample, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8:
      return launch_lanes<8>(in, out, action, reward, done, lines, packed, box, ids, B, params,
                             sample, st);
    case 16:
      return launch_lanes<16>(in, out, action, reward, done, lines, packed, box, ids, B, params,
                              sample, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Envs a block of the init for a batch of B: kInitThreads, or where B's envs
// give the card's SMs fewer than kInitThreads each, as many as give every
// SM a block.  (Sharing 65536 envs evenly, 249 a block and two blocks an
// SM, was 6% slower on an H100: PERF.md.)
static int init_envs(int B) {
  const int sms = sm_count();
  return std::min(kInitThreads, std::max(1, (B + sms - 1) / sms));
}

// keys: uint32[B, 2] (mesh.batch_keys layout); out's board starts on a
// 16-byte boundary.
extern "C" int flagship_init_launch(const void* keys, const FlagshipPtrs* out, const void* box,
                                    int B, int uniform, void* stream) {
  static bool opted = false;
  if (const cudaError_t err = allow_smem(flagship_init_kernel, kInitSmem, opted)) return err;
  const int E = init_envs(B);
  flagship_init_kernel<<<(B + E - 1) / E, kInitThreads, kInitSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), *out, static_cast<const int32_t*>(box), B, E, uniform);
  return static_cast<int>(cudaGetLastError());
}

// The init's shape for a batch of B: out = [envs a block, threads a block,
// bytes a board word].
extern "C" int flagship_init_shape(int B, int* out) {
  out[0] = init_envs(B);
  out[1] = kInitThreads;
  out[2] = 16;
  return 0;
}

// Envs a warp of the observation for a batch of B: one while B gives the
// card's SMs at most kObsOneEnvWarpsPerSM warps each, else kObsWarpEnvs.
static int obs_envs_per_warp(int B) {
  return B <= kObsOneEnvWarpsPerSM * sm_count() ? 1 : kObsWarpEnvs;
}

// Warps a block of the observation for a batch of B: kObsWarps, or where
// B's warps give the card's SMs fewer than kObsWarps each, as many as give
// every SM a block.
static int obs_warps_per_block(int B) {
  const int warps = (B + obs_envs_per_warp(B) - 1) / obs_envs_per_warp(B);
  return std::min(kObsWarps, std::max(1, (warps + sm_count() - 1) / sm_count()));
}

template <int E>
static int launch_observe_board(const void* board, const void* piece, const void* rotation,
                                const void* x, const void* y, const void* game_over,
                                const void* packed, void* out, int B, cudaStream_t stream) {
  static bool opted = false;
  constexpr int smem = ObsBuild<E>::WARP_SMEM;
  if (const cudaError_t err = allow_smem(flagship_observe_board_kernel<E>, kObsWarps * smem, opted))
    return err;
  const int warps = obs_warps_per_block(B);
  const int blocks = ((B + E - 1) / E + warps - 1) / warps;
  flagship_observe_board_kernel<E><<<blocks, 32 * warps, warps * smem, stream>>>(
      static_cast<const int8_t*>(board), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const int32_t*>(x),
      static_cast<const int32_t*>(y), static_cast<const uint8_t*>(game_over),
      static_cast<const uint32_t*>(packed), static_cast<int8_t*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flagship_observe_board_launch(const void* board, const void* piece,
                                             const void* rotation, const void* x, const void* y,
                                             const void* game_over, const void* packed, void* out,
                                             int B, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return obs_envs_per_warp(B) == 1
             ? launch_observe_board<1>(board, piece, rotation, x, y, game_over, packed, out, B, st)
             : launch_observe_board<kObsWarpEnvs>(board, piece, rotation, x, y, game_over, packed, out,
                                                  B, st);
}

// The observation's shape for a batch of B: out = [envs a warp, warps a
// block, words of an env, bytes of a word, rounds a lane].
extern "C" int flagship_observe_board_shape(int B, int* out) {
  const int E = obs_envs_per_warp(B);
  out[0] = E;
  out[1] = obs_warps_per_block(B);
  out[2] = NIW;
  out[3] = WI;
  out[4] = E == 1 ? ObsBuild<1>::ROUNDS : ObsBuild<kObsWarpEnvs>::ROUNDS;
  return 0;
}
