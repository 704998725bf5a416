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
// selected.  The state is batch-leading: the id board int8[B, H, PW] (432
// bytes an env at 10x20) and small per-env fields, the key uint32[B, 2].
//
// fn_step (a group of kLanes = 8 lanes an env, kStepEnvs = 16 envs in a
// block of 128 threads): the block's boards, contiguous in memory, come
// into shared memory with one cp.async.bulk completing on an mbarrier (the
// bulk build, where the span is a multiple of 16 bytes on 16-byte
// boundaries) or with the block's 16-byte or byte words (the words build,
// e.g. 8x12 with padding 2, 168 bytes a board); the envs' fields load
// meanwhile.  The group turns its board into one 64-bit bit row of
// occupancy a padded row (lane l rows l, l + 8, ..) and plays the env:
// every lane runs the env's scalar logic, the same on each, so nothing
// needs broadcasting; a window test is S row tests at the clamped start,
// lane s on row s, voted with __any_sync; the drop tests 8 window starts at
// a time, a lane a start, and a ballot takes the least that collides; a
// lock stamps the window's rows a lane a row, finds the full rows by an OR
// over the group, and moves each kept row down by the count of full rows
// below it, a lane a column.  Threefry and the queue run on the group's
// first lane, which hands the new piece and key to the others by shuffles.
// The boards go back with one bulk store (or the words), and the block
// writes the observation int8[B, HEIGHT, WIDTH] in 4-byte words from the
// boards in shared memory and each env's active window.  fn_observe keeps
// its first design: a block of 256 threads takes kEnvs envs (64 at 10x20),
// thread e an env.
//
// fn_reset (a block of 256 threads for E envs, E = min(128, ceil(B / SMs))
// rounded up so that a block's boards and observations are whole 16-byte
// words, at most 64 at 30x20; no block-wide barrier): the board tensor is B
// copies of one pattern known at compile time, and the observation is zeros
// but for the spawned piece's cells in rows 0 .. S - 1, which are -1.  Warps
// stream the board as 16-byte words, each computed from its byte offset
// where it is stored (one word throughout where a thread's stride is a
// multiple of the pattern's period), and the observation's words that no
// piece can touch as zeros, while the env warps run one short RNG chain an
// env (the key one 8-byte load, split once; the bag's sort keys placed by
// their ranks, no insertion sort), put the queues through a warp's tile and
// write the observation words their pieces touch.  What held the first design back: every board filled in shared memory a
// byte at a time and copied out, 192 of 256 threads waiting at a barrier
// for 64 serial chains with an insertion sort each, and the observation
// computed a byte at a time from the staged boards; B = 8192 gave 128
// blocks for the 132 SMs.
//
// What held the step's first design back (one thread an env in that
// layout): at B = 65536 its 1024 blocks ran in 1.11 waves (7 blocks an SM
// by their 27 KB of boards), six of a block's eight warps waited at its
// barriers, each thread walked byte windows, a drop and a 20-row
// compaction serially, and the observation took ~30 instructions a byte.  Here 4096 blocks of 128
// threads run 12 an SM (40 registers, no spill), the window tests are a
// word each, the observation is built from bit maps of the cells (4 bytes
// from two nibbles), and a lane holds its share of the queue from the
// start, so a lock reads no queue entry from global memory.
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
// step's boards of a block live in shared memory, which with their windows
// stay within 48 KB (CELLS <= 3056 at 16 envs a block; the reset stages no
// board, so the limit binds only the step and fn_observe's envs a block),
// a piece's S x S matrix is one 64-bit mask (S <= 8), and the step's bit
// rows and maps of window starts are 64-bit words (H <= 64, PW <= 64).

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "sm_count.cuh"
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
  int bulk;  // fn_step: the bulk-copy build
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
// Envs a block of fn_observe: 64, 32 or 16, as many as fit the boards and
// windows (16 bytes each, struct Active) that the first design of the
// reset staged in the 48 KB of shared memory a block has without opting in.
constexpr int kSharedBytes = 48 * 1024;
constexpr int kEnvs = 64 * (CELLS + 16) <= kSharedBytes ? 64 : 32 * (CELLS + 16) <= kSharedBytes ? 32 : 16;
static_assert(PAD >= 1 && HEIGHT >= 1 && WIDTH >= 1 && S <= 8 && S <= H && S <= PW,
              "kernels.py:fn_defines limits");
static_assert(kEnvs * (CELLS + 16) <= kSharedBytes, "a block's boards fit 48 KB of shared memory");
// Threads a block of fn_observe: threads 0 .. kEnvs - 1 each take one env,
// and all of them write the observations.
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

// ---------------------------------------------------------------------------
// fn_step: a group of kLanes lanes an env
// ---------------------------------------------------------------------------

constexpr int kLanes = 8;                         // lanes an env
constexpr int kStepEnvs = 16;                     // envs a block
constexpr int kStepThreads = kStepEnvs * kLanes;  // 128
constexpr int kQueueSlots = (QS + kLanes - 1) / kLanes;  // queue entries a lane holds
constexpr int kFlatWords = (CELLS + 31) / 32;  // the board's occupancy, 32 bytes a word
constexpr int kObsWords = (OBS + 31) / 32;     // the observation's cells, 32 a word
// Shared memory of a block: the boards, then a board each of bit rows, of
// flat occupancy (2 words past the end, read and masked off) and of the
// observation's two bit maps (occupied, active).
constexpr int kBoardBytes = (kStepEnvs * CELLS + 15) / 16 * 16;
constexpr int kOccBytes = kStepEnvs * H * 8;
constexpr int kFlatBytes = kStepEnvs * (kFlatWords + 2) * 4;
constexpr int kStepSmem = kBoardBytes + kOccBytes + kFlatBytes + kStepEnvs * 2 * kObsWords * 4;
constexpr uint64_t kWidthMask = WIDTH >= 64 ? ~0ull : (1ull << WIDTH) - 1;
static_assert(S <= kLanes, "a window's rows are tested a lane each");
static_assert(H <= 64 && PW <= 64, "a bit row and a map of window starts are 64-bit words");

// The lanes of one env: its index in the group, the group's lanes in the
// warp and the first of them.
struct Group {
  int lane, base;
  unsigned mask;
};

// Row s of a piece's S x S mask, S bits.
__device__ __forceinline__ uint64_t piece_row(uint64_t m, int s) {
  return (m >> (s * S)) & ((1ull << S) - 1);
}

// The occupancy of a padded row: bit c is cell c > 0.
__device__ __forceinline__ uint64_t row_bits(const int8_t* row) {
  uint64_t v = 0;
#pragma unroll 8
  for (int c = 0; c < PW; ++c) v |= static_cast<uint64_t>(row[c] > 0) << c;
  return v;
}

// Bit k of the result: byte k of w, an int8, is > 0 (nonzero, sign clear).
__device__ __forceinline__ uint32_t positive_bits4(uint32_t w) {
  const uint32_t nonzero = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (((nonzero & ~w) >> 7) * 0x10204080u) >> 28;
}

// Flat occupancy word j of a board that is whole 4-byte words: bit k is
// byte 32 j + k > 0.  Bytes past the board (another board's, or the next
// region of shared memory) are read and masked off.
__device__ __forceinline__ uint32_t flat_word(const int8_t* b, int j) {
  uint32_t v = 0;
  if constexpr (CELLS % 16 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(b) + 2 * j;
    const uint4 lo = q[0], hi = q[1];
    v = positive_bits4(lo.x) | positive_bits4(lo.y) << 4 | positive_bits4(lo.z) << 8 |
        positive_bits4(lo.w) << 12 | positive_bits4(hi.x) << 16 | positive_bits4(hi.y) << 20 |
        positive_bits4(hi.z) << 24 | positive_bits4(hi.w) << 28;
  } else {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(b) + 8 * j;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= positive_bits4(q[k]) << (4 * k);
  }
  const int valid = CELLS - 32 * j;
  return valid >= 32 ? v : v & ((1u << valid) - 1u);
}

// Bit row r cut from the board's flat words (2 words past the end readable).
__device__ __forceinline__ uint64_t cut_row(const uint32_t* flat, int r) {
  const int bit = r * PW, w0 = bit >> 5, sh = bit & 31;
  uint64_t v = (static_cast<uint64_t>(flat[w0 + 1]) << 32 | flat[w0]) >> sh;
  if (sh + PW > 64) v |= static_cast<uint64_t>(flat[w0 + 2]) << (64 - sh);
  return PW == 64 ? v : v & ((1ull << (PW % 64)) - 1);
}

// The bit rows occ[0 .. H) of the group's board.  Where the board is whole
// 4-byte words, lane l first packs bytes 32 j .. 32 j + 31 (j = l, l + 8,
// ..) into flat word j, then cuts rows l, l + 8, .. from the flat words;
// else a row's bytes are read one by one.
__device__ void build_occ(const Group& g, const int8_t* b, uint32_t* flat, uint64_t* occ) {
  if constexpr (CELLS % 4 == 0) {
    for (int j = g.lane; j < kFlatWords; j += kLanes) flat[j] = flat_word(b, j);
    __syncwarp(g.mask);
    for (int r = g.lane; r < H; r += kLanes) occ[r] = cut_row(flat, r);
  } else {
    for (int r = g.lane; r < H; r += kLanes) occ[r] = row_bits(b + r * PW);
  }
  __syncwarp(g.mask);
}

// Byte k of the result: bit k of the nibble n.
__device__ __forceinline__ uint32_t spread4(uint32_t n) { return (n * 0x00204081u) & 0x01010101u; }

// Row r of the observation: the playfield's occupancy, WIDTH bits.
__device__ __forceinline__ uint64_t obs_row(const uint64_t* occ, int r) {
  return (occ[r] >> PAD) & kWidthMask;
}

// Row r of the observation: the active piece's cells (mask m at the
// clamped window (xc, yc)), WIDTH bits.
__device__ __forceinline__ uint64_t act_row(uint64_t m, int xc, int yc, int r) {
  const int ar = r - yc;
  return ar >= 0 && ar < S ? ((piece_row(m, ar) << xc) >> PAD) & kWidthMask : 0ull;
}

// observe of the group's env as two bit maps of its HEIGHT x WIDTH cells
// (cell i is bit i % 32 of word i / 32): the playfield's occupancy from the
// bit rows and the active piece's cells (m is 0 once the game is over).
// Lane l builds words l, l + 8, .., each from the rows it spans.
__device__ void group_obs_maps(const Group& g, uint32_t* maps, const uint64_t* occ, uint64_t m, int xc,
                               int yc) {
  for (int k = g.lane; k < kObsWords; k += kLanes) {
    uint32_t o = 0, a = 0;
    int r = 32 * k / WIDTH, c = 32 * k - r * WIDTH;
    for (int got = 0; got < 32 && r < HEIGHT; ++r, c = 0) {
      const int n = min(32 - got, WIDTH - c);
      const uint32_t low = n == 32 ? ~0u : (1u << n) - 1u;
      o |= (static_cast<uint32_t>(obs_row(occ, r) >> c) & low) << got;
      a |= (static_cast<uint32_t>(act_row(m, xc, yc, r) >> c) & low) << got;
      got += n;
    }
    maps[k] = o;
    maps[kObsWords + k] = a;
  }
}

// observe of the block's nb envs from their bit maps: occupied minus
// active, 4 bytes a word (nibble i / 4 of the maps) where an observation is
// whole words, else a byte at a time; neighbouring threads on neighbouring
// words.
__device__ void write_obs_maps(int8_t* obs, const uint32_t* maps, int nb) {
  if constexpr (OBS % 4 == 0) {
    constexpr int kWords = OBS / 4;
    for (int w = threadIdx.x; w < nb * kWords; w += blockDim.x) {
      const int e = w / kWords, i = 4 * (w - e * kWords);
      const uint32_t* mp = maps + e * 2 * kObsWords + (i >> 5);
      const uint32_t o = spread4((mp[0] >> (i & 31)) & 0xFu);
      const uint32_t a = spread4((mp[kObsWords] >> (i & 31)) & 0xFu);
      reinterpret_cast<uint32_t*>(obs)[w] = (o & ~a) | ((a & ~o) * 0xFFu);  // 1, 0 or -1 a byte
    }
  } else {
    for (int j = threadIdx.x; j < nb * OBS; j += blockDim.x) {
      const int e = j / OBS, i = j - e * OBS;
      const uint32_t* mp = maps + e * 2 * kObsWords + (i >> 5);
      obs[j] = static_cast<int8_t>(static_cast<int>((mp[0] >> (i & 31)) & 1u) -
                                   static_cast<int>((mp[kObsWords] >> (i & 31)) & 1u));
    }
  }
}

template <typename T>
__device__ __forceinline__ T group_or(T v, unsigned mask) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v |= __shfl_xor_sync(mask, v, o, kLanes);
  return v;
}

// A filled cell of the piece over an occupied cell of the window at (xc,
// yc): S row tests, lane s on window row s.
__device__ __forceinline__ bool group_hits(const Group& g, const uint64_t* occ, uint64_t m, int xc,
                                           int yc) {
  const bool hit = g.lane < S && ((occ[yc + g.lane] >> xc) & piece_row(m, g.lane)) != 0;
  return __any_sync(g.mask, hit);
}

__device__ __forceinline__ bool group_collides(const Group& g, const uint64_t* occ, uint64_t m, int x,
                                               int y) {
  return group_hits(g, occ, m, clamp_start(x, PW - S, PW), clamp_start(y, H - S, H));
}

// drop_distance over the group: the window starts r0, r0 + 1, .. (the row
// y + 1 + d clipped without the wrap to [0, H - S]) are tested kLanes at a
// time, a lane a start, and a ballot takes the least that collides.  Offset
// d tests start clip(y + 1 + d): the least colliding start r gives d = 0 if
// r is the first start tested, else r - (y + 1); none, or d >= H, gives H.
__device__ int group_drop(const Group& g, const uint64_t* occ, uint64_t m, int x, int y) {
  const int xc = clamp_start(x, PW - S, PW);
  const int r0 = min(max(y + 1, 0), H - S);
  for (int first = r0; first <= H - S; first += kLanes) {
    const int r = first + g.lane;
    bool hit = false;
    if (r <= H - S) {
#pragma unroll
      for (int s = 0; s < S; ++s) hit |= ((occ[r + s] >> xc) & piece_row(m, s)) != 0;
    }
    const unsigned hits = (__ballot_sync(g.mask, hit) >> g.base) & ((1u << kLanes) - 1);
    if (hits != 0) {
      const int least = first + __ffs(hits) - 1;
      if (least == r0) return 0;
      const int d = least - (y + 1);
      return d < H ? d : H;
    }
  }
  return H;
}

// The lock's board work over the group: ADD id into the piece's cells of the
// clamped window (a lane a window row), the window rows' occupancy anew,
// the full playfield rows by ballot, each kept row moved down by the count
// of full rows below it (a lane a column, bottom up, so a cell is read
// before it is written), the n top rows set to the pre-clear row 0, and the
// frame rewritten as bedrock.  Returns n.
__device__ int group_lock(const Group& g, int8_t* b, uint64_t* occ, uint64_t m, int x, int y, int id) {
  const int xc = clamp_start(x, PW - S, PW), yc = clamp_start(y, H - S, H);
  if (g.lane < S) {
    int8_t* row = b + (yc + g.lane) * PW + xc;
    for (uint64_t r = piece_row(m, g.lane); r; r &= r - 1) {
      const int j = __ffsll(static_cast<long long>(r)) - 1;
      row[j] = static_cast<int8_t>(row[j] + id);
    }
    occ[yc + g.lane] = row_bits(b + (yc + g.lane) * PW);
  }
  __syncwarp(g.mask);
  uint64_t mine = 0;
  for (int r = g.lane; r < HEIGHT; r += kLanes)
    if (((occ[r] >> PAD) & kWidthMask) == kWidthMask) mine |= 1ull << r;
  const uint64_t full = group_or(mine, g.mask);
  const int n = __popcll(full);
  if (n > 0) {
    for (int c = PAD + g.lane; c < PAD + WIDTH; c += kLanes) {
      const int8_t top = b[c];
      int k = 0;
      for (int r = HEIGHT - 1; r >= 0; --r) {
        if ((full >> r) & 1u) ++k;
        else if (k > 0) b[(r + k) * PW + c] = b[r * PW + c];
      }
      for (int r = 1; r < n; ++r) b[r * PW + c] = top;
    }
  }
  for (int r = g.lane; r < HEIGHT; r += kLanes) {
#pragma unroll
    for (int c = 0; c < PAD; ++c) {
      b[r * PW + c] = BEDROCK;
      b[r * PW + PAD + WIDTH + c] = BEDROCK;
    }
  }
  for (int i = g.lane; i < PAD * PW; i += kLanes) b[HEIGHT * PW + i] = BEDROCK;
  __syncwarp(g.mask);
  return n;
}

// The spawn test on the bytes of rows 0 .. S - 1 after the lock.
__device__ __forceinline__ bool group_spawn_hits(const Group& g, const int8_t* b, uint64_t m) {
  bool hit = false;
  if (g.lane < S) {
    const int8_t* row = b + g.lane * PW + clamp_start(SPAWN_X, PW - S, PW);
    for (uint64_t r = piece_row(m, g.lane); r; r &= r - 1)
      hit |= row[__ffsll(static_cast<long long>(r)) - 1] > 0;
  }
  return __any_sync(g.mask, hit);
}

// kBulk: the block's boards (nb * CELLS contiguous bytes, a multiple of
// 16 on 16-byte boundaries) come in with one cp.async.bulk completing on an
// mbarrier, and go out with one bulk store; else the block copies them in
// 16-byte or single-byte words (block_copy).  kernels.py:fn_step_build
// picks the build from the geometry and the pointers.
template <bool kBulk>
__global__ void __launch_bounds__(kStepThreads) fn_step_kernel(FnPtrs in, FnPtrs out,
                                                            const int32_t* __restrict__ action,
                                                            int8_t* __restrict__ obs,
                                                            float* __restrict__ reward,
                                                            uint8_t* __restrict__ terminated,
                                                            int32_t* __restrict__ lines,
                                                            const uint64_t* __restrict__ masks,
                                                            const int32_t* __restrict__ ids, int B,
                                                            FnParams p) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ uint64_t bar;
  int8_t* boards = smem;
  uint32_t* maps = reinterpret_cast<uint32_t*>(smem + kBoardBytes + kOccBytes + kFlatBytes);
  const int e0 = blockIdx.x * kStepEnvs, nb = min(kStepEnvs, B - e0), t = threadIdx.x;
  const uint32_t span = static_cast<uint32_t>(nb * CELLS);
  if constexpr (kBulk) {
    if (t == 0) {  // the other threads wait on the barrier after the __syncthreads below
      bulk::barrier_init(&bar, 1);
      bulk::arrive_expect(&bar, span);
      bulk::load(boards, in.board + static_cast<long long>(e0) * CELLS, span, &bar);
    }
  } else {
    block_copy(boards, in.board + static_cast<long long>(e0) * CELLS, span);
  }
  const int ge = t / kLanes;
  const Group g{t % kLanes, (t % 32) / kLanes * kLanes, ((1u << kLanes) - 1) << ((t % 32) / kLanes * kLanes)};
  const int e = e0 + ge;
  // the env's fields, read by every lane of its group (one address a group)
  bool over_in = true;
  int piece = 0, rot = 0, x = 0, y = 0, qi = 0, a = 0;
  float score = 0.0f;
  uint32_t k0 = 0, k1 = 0;
  int32_t qv[kQueueSlots];  // queue entries lane + 8 i, in flight with the boards
  if (ge < nb) {
#pragma unroll
    for (int i = 0; i < kQueueSlots; ++i) {
      const int j = g.lane + i * kLanes;
      qv[i] = j < QS ? in.queue[static_cast<long long>(e) * QS + j] : 0;
    }
    over_in = in.game_over[e];
    piece = in.piece[e];
    rot = in.rotation[e];
    x = in.x[e];
    y = in.y[e];
    qi = in.queue_index[e];
    score = in.score[e];
    k0 = in.rng_key[2 * e];
    k1 = in.rng_key[2 * e + 1];
    a = action[e];
  }
  __syncthreads();
  if constexpr (kBulk) bulk::wait(&bar, 0);
  if (ge < nb) {
    int8_t* b = boards + ge * CELLS;
    uint64_t* occ = reinterpret_cast<uint64_t*>(smem + kBoardBytes) + ge * H;
    uint32_t* flat = reinterpret_cast<uint32_t*>(smem + kBoardBytes + kOccBytes) + ge * (kFlatWords + 2);
    int cur = piece, n = 0;
    bool over = over_in, refill = false;
    float new_score = score;
    build_occ(g, b, flat, occ);
    if (!over_in) {
      uint64_t m = piece_mask(masks, piece, rot);
      // the horizontal move, with the old rotation
      const int dx = a == 0 ? -1 : a == 1 ? 1 : 0;
      if (dx != 0 && !group_collides(g, occ, m, x + dx, y)) x += dx;
      // down or hard drop, at the new x
      int y_new = y, move = 0;
      if (a == 2) {
        if (!group_collides(g, occ, m, x, y + 1)) {
          y_new = y + 1;
          move = 1;
        }
      } else if (a == 6) {
        const int d = group_drop(g, occ, m, x, y);
        y_new = y + d;
        move = 2 * d;
      }
      // rotation, checked at the new x and y
      const int rd = a == 3 ? -1 : a == 4 ? 1 : 0;
      if (rd != 0) {
        const int rc = ((rot + rd) % 4 + 4) % 4;
        if (!group_collides(g, occ, piece_mask(masks, piece, rc), x, y_new)) rot = rc;
      }
      m = piece_mask(masks, piece, rot);
      // gravity, with the new rotation; a lock on a blocked fall or a hard drop
      int y_g = y_new;
      bool lock = a == 6;
      if (p.gravity) {
        if (group_collides(g, occ, m, x, y_new + 1)) lock = true;
        else y_g = y_new + 1;
      }
      int lock_reward = 0;
      if (lock) {
        const int at_id = min(max(piece < 0 ? piece + NP : piece, 0), NP - 1);
        n = group_lock(g, b, occ, m, x, y_g, __ldg(ids + at_id));
        build_occ(g, b, flat, occ);  // the board after the clear, for the observation
        lock_reward = score_fn(n);
        // the key and the queue, on the group's first lane
        refill = qi >= QS;
        if (!refill) {  // queue entry idx from the lane that holds it
          const int idx = min(max(qi < 0 ? qi + QS : qi, 0), QS - 1);
          int32_t v = 0;
#pragma unroll
          for (int i = 0; i < kQueueSlots; ++i) v = i == idx / kLanes ? qv[i] : v;
          cur = __shfl_sync(g.mask, v, idx % kLanes, kLanes);
        }
        if (g.lane == 0) {
          const uint2 next = tf::block(k0, k1, 0u, 0u);
          if (refill) {
            const uint2 sub = tf::block(k0, k1, 0u, 1u);
            int32_t q[QS];
            fresh_queue(sub.x, sub.y, p.uniform != 0, q);
#pragma unroll
            for (int i = 0; i < QS; ++i) out.queue[static_cast<long long>(e) * QS + i] = q[i];
            cur = q[0];
          }
          k0 = next.x;
          k1 = next.y;
        }
        if (refill) cur = __shfl_sync(g.mask, cur, 0, kLanes);
        k0 = __shfl_sync(g.mask, k0, 0, kLanes);
        k1 = __shfl_sync(g.mask, k1, 0, kLanes);
        qi = refill ? 1 : qi + 1;
        rot = 0;
        x = SPAWN_X;
        y = 0;
        over = group_spawn_hits(g, b, piece_mask(masks, cur, 0));
      } else {
        y = y_g;
        over = false;
      }
      new_score = __fadd_rn(__fadd_rn(score, static_cast<float>(move)),
                            static_cast<float>(lock_reward));
    }
    if (!refill) {
#pragma unroll
      for (int i = 0; i < kQueueSlots; ++i) {
        const int j = g.lane + i * kLanes;
        if (j < QS) out.queue[static_cast<long long>(e) * QS + j] = qv[i];
      }
    }
    if (g.lane == 0) {
      out.rng_key[2 * e] = k0;
      out.rng_key[2 * e + 1] = k1;
      out.piece[e] = cur;
      out.rotation[e] = rot;
      out.x[e] = x;
      out.y[e] = y;
      out.queue_index[e] = qi;
      out.game_over[e] = over;
      out.score[e] = new_score;
      reward[e] = __fsub_rn(new_score, score);
      terminated[e] = over;
      lines[e] = n;
    }
    group_obs_maps(g, maps + ge * 2 * kObsWords, occ, over ? 0ull : piece_mask(masks, cur, rot),
                   clamp_start(x, PW - S, PW), clamp_start(y, H - S, H));
  }
  if constexpr (kBulk) bulk::fence_shared();
  __syncthreads();
  int8_t* board_out = out.board + static_cast<long long>(e0) * CELLS;
  if constexpr (kBulk) {
    if (t == 0) {
      bulk::store(board_out, boards, span);
      bulk::commit();
    }
  } else {
    block_copy(board_out, boards, span);
  }
  write_obs_maps(obs + static_cast<long long>(e0) * OBS, maps, nb);
  if constexpr (kBulk) {
    if (t == 0) bulk::wait_read();
  }
}

// ---------------------------------------------------------------------------
// fn_reset: word streams of the constant board and observation beside one
// short RNG chain an env
// ---------------------------------------------------------------------------

constexpr int gcd_of(int a, int b) { return b == 0 ? a : gcd_of(b, a % b); }
// _clamp_start at compile time.
constexpr int clamp_const(int v, int limit, int dim) {
  return (v < 0 ? v + dim : v) < 0 ? 0 : (v < 0 ? v + dim : v) > limit ? limit : (v < 0 ? v + dim : v);
}

constexpr int kResetThreads = 256;
constexpr int kResetWarps = kResetThreads / 32;
// Envs a block at most: 128, or the largest power of two whose boards and
// observations take at most 128 KB (64 at 30x20: a block of 128 envs there
// took 39% longer at B = 65536), at least kEnvAlign.
constexpr int pow2_floor(int v) { return v >= 2 ? 2 * pow2_floor(v / 2) : 1; }
constexpr int kResetMaxEnvs = pow2_floor(131072 / (CELLS + OBS)) < 128 ? pow2_floor(131072 / (CELLS + OBS)) : 128;
static_assert(kResetMaxEnvs >= 16, "a block of the reset holds a multiple of kEnvAlign envs");
// Envs whose observations, and whose boards, are whole 16-byte words (powers
// of two: the larger is their lcm); a block's envs are a multiple of it,
// so that no word of either tensor spans two blocks.
constexpr int kObsAlign = 16 / gcd_of(OBS, 16);
constexpr int kBoardAlign = 16 / gcd_of(CELLS, 16);
constexpr int kEnvAlign = kObsAlign > kBoardAlign ? kObsAlign : kBoardAlign;
constexpr int kBoardPeriod = kBoardAlign * CELLS / 16;  // words of the board stream's period
constexpr int kWordRows = 15 / PW + 2;                  // board rows a 16-byte word touches at most
// The spawned piece's window (rotation 0 at (SPAWN_X, 0), clamped) in an
// env's observation: rows 0 .. kWinRows - 1, columns kWinC0 .. kWinC1 - 1;
// its bytes lie in [kWinLo, kWinHi), kWinWords 16-byte words at most.
constexpr int kSpawnXc = clamp_const(SPAWN_X, PW - S, PW);
constexpr int kWinRows = S < HEIGHT ? S : HEIGHT;
constexpr int kWinC0 = kSpawnXc - PAD > 0 ? kSpawnXc - PAD : 0;
constexpr int kWinC1 = kSpawnXc - PAD + S < WIDTH ? kSpawnXc - PAD + S : WIDTH;
constexpr bool kHasWin = kWinC0 < kWinC1;
constexpr int kWinLo = kWinC0;
constexpr int kWinHi = (kWinRows - 1) * WIDTH + kWinC1;
constexpr int kWinWords = kHasWin ? (kWinHi - kWinLo + 14) / 16 + 1 : 0;

// create_board's cell c of a board (0 <= c < CELLS): 1 on the bedrock (the
// pad columns and the rows below the playfield), 0 inside.
__device__ __forceinline__ int8_t reset_cell(int c) {
  const int r = c / PW, w = c - r * PW;
  return (r >= HEIGHT || w < PAD || w >= PAD + WIDTH) ? BEDROCK : 0;
}

// The 16 bytes of create_board's boards laid end to end from byte o of a
// board (0 <= o < CELLS): byte i is cell (o + i) mod CELLS.  The word's
// playfield cells are bits, an interval of each playfield row that it
// touches (row r / PW of the stream is row r mod H of a board), and each 4
// bits become a 32-bit lane of bytes.
__device__ __forceinline__ uint4 reset_board_word(int o) {
  const int r0 = o / PW;
  uint32_t play = 0u;
#pragma unroll
  for (int k = 0; k < kWordRows; ++k) {
    const int r = r0 + k, at = r * PW + PAD - o;  // the row's first playfield cell, from o
    const int lo = max(at, 0), hi = min(at + WIDTH, 16);
    if (r % H < HEIGHT && lo < hi) play |= (0xFFFFu >> (16 - hi)) & ~((1u << lo) - 1u);
  }
  const uint32_t rock = ~play;
  return make_uint4(spread4(rock & 15u), spread4((rock >> 4) & 15u), spread4((rock >> 8) & 15u),
                    spread4((rock >> 12) & 15u));
}

// Whether the 16-byte word at byte g of observations laid end to end from
// an env's first byte holds a byte that an env's spawned piece can cover.
__device__ __forceinline__ bool piece_word(int g) {
  if constexpr (!kHasWin) return false;
  for (int k = g / OBS; k * OBS < g + 16; ++k)
    if (k * OBS + kWinHi > g && k * OBS + kWinLo < g + 16) return true;
  return false;
}

// The spawned piece (mask m, rotation 0) in its window of the observation:
// byte r is row r's cells from column kWinC0 (S <= 8 bits).
__device__ __forceinline__ uint64_t window_rows(uint64_t m) {
  uint64_t rows = 0ull;
#pragma unroll
  for (int r = 0; r < kWinRows; ++r) rows |= ((act_row(m, kSpawnXc, 0, r) >> kWinC0) & 0xFFull) << (8 * r);
  return rows;
}

// Envs whose observations a 16-byte word can touch.
constexpr int kSpanEnvs = (15 + OBS - 1) / OBS + 1;

// Bit i: byte g + i of the observations of envs 0 .. n - 1 laid end to end
// is a cell of its env's spawned piece, so -1; rows[k] is env k's
// window_rows, and no env before e has a window in the word.
__device__ __forceinline__ uint32_t piece_bits(int g, int e, const uint64_t* rows, int n) {
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < kSpanEnvs; ++j) {
    if (e + j >= n) break;
    const uint64_t w = rows[e + j];
    const int base = (e + j) * OBS + kWinC0 - g;  // the word's byte where window row 0 starts
#pragma unroll
    for (int r = 0; r < kWinRows; ++r) {
      const int at = base + r * WIDTH;
      const uint32_t row = static_cast<uint32_t>(w >> (8 * r)) & 0xFFu;
      if (at > -8 && at < 16) bits |= at >= 0 ? row << at : row >> -at;
    }
  }
  return bits & 0xFFFFu;
}

// A block's streams from thread si of S: the board words of its n envs
// (one word throughout where S is a multiple of the period; the tensor's
// ragged end byte by byte), and the observation words that no piece can
// touch, zeros.  The block's boards and observations start on 16 bytes.
__device__ __forceinline__ void stream_reset(int8_t* board, int8_t* obs, int n, int si, int S) {
  const int bwords = n * CELLS / 16;
  const int SB = S >= kBoardPeriod ? S / kBoardPeriod * kBoardPeriod : S;
  if (si < SB) {
    const bool fixed = SB % kBoardPeriod == 0;
    const int step = (16 * SB) % CELLS;
    int o = (16 * si) % CELLS;
    const uint4 w0 = reset_board_word(o);
    for (int i = si; i < bwords; i += SB) {
      reinterpret_cast<uint4*>(board)[i] = fixed ? w0 : reset_board_word(o);
      o += step;
      if (o >= CELLS) o -= CELLS;
    }
  }
  for (int i = 16 * bwords + si; i < n * CELLS; i += S) board[i] = reset_cell(i % CELLS);
  const int owords = n * OBS / 16;
  for (int i = si; i < owords; i += S)
    if (!piece_word(16 * i)) reinterpret_cast<uint4*>(obs)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// count ints from a warp's tile to dst, as 16-byte words where dst lies on
// a 16-byte boundary and count is a multiple of 4.
__device__ __forceinline__ void store_ints(int32_t* dst, const int32_t* tile, int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0 && (count & 3) == 0) {
    for (int f = lane; f < count / 4; f += 32)
      reinterpret_cast<uint4*>(dst)[f] = reinterpret_cast<const uint4*>(tile)[f];
  } else {
    for (int f = lane; f < count; f += 32) dst[f] = tile[f];
  }
}

// create_bag's permutation from key k (one round: the subkey's 32-bit sort
// keys, a stable sort of iota) as ranks: entry i goes to place rank_i, the
// count of j with (sk[j], j) < (sk[i], i); or create_uniform's draws.
__device__ __forceinline__ void ranked_queue(uint2 k, bool uniform, int32_t (&q)[QS]) {
  if (uniform || kRounds == 0) {
    fresh_queue(k.x, k.y, uniform, q);
    return;
  }
  const uint2 sub = tf::block(k.x, k.y, 0u, 1u);
  uint32_t sk[QS];
#pragma unroll
  for (int i = 0; i < QS; ++i) {
    sk[i] = tf::bits(sub.x, sub.y, 0u, i);
    q[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < QS; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < QS; ++j) rank += sk[j] < sk[i] || (sk[j] == sk[i] && j < i);
#pragma unroll
    for (int p = 0; p < QS; ++p) q[p] = rank == p ? i : q[p];
  }
}

// A warp's m envs from env b0, a lane an env.  The key is one 8-byte load,
// split once: the first half draws the queue and comes back, the second is
// the state's stream.  The queues go out through the warp's tile, the
// scalar fields a store an env; then the warp writes the observation words
// its envs' pieces touch (the others are the streams' zeros), and the
// tensor's ragged end byte by byte.  The warp's envs' observations start on
// 16 bytes and are whole words but at the tensor's end.
__device__ __forceinline__ void reset_warp(const uint32_t* keys, uint32_t* keys_out, const FnPtrs& out,
                                           int8_t* obs, const uint64_t* masks, long long b0, int m,
                                           int lane, bool uniform, int32_t* tile, uint64_t* wm) {
  const bool live = lane < m;
  uint2 key = make_uint2(0u, 0u);
  if (live) key = __ldg(reinterpret_cast<const uint2*>(keys) + b0 + lane);
  const uint2 first = tf::block(key.x, key.y, 0u, 0u), second = tf::block(key.x, key.y, 0u, 1u);
  int32_t q[QS];
  ranked_queue(first, uniform, q);
  if (live) {
    const long long e = b0 + lane;
#pragma unroll
    for (int j = 0; j < QS; ++j) tile[lane * QS + j] = q[j];
    reinterpret_cast<uint2*>(keys_out)[e] = first;
    reinterpret_cast<uint2*>(out.rng_key)[e] = second;
    out.piece[e] = q[0];
    out.rotation[e] = 0;
    out.x[e] = SPAWN_X;
    out.y[e] = 0;
    out.queue_index[e] = 1;
    out.game_over[e] = 0;
    out.score[e] = 0.0f;
    wm[lane] = window_rows(piece_mask(masks, q[0], 0));
  }
  __syncwarp();
  store_ints(out.queue + b0 * QS, tile, m * QS, lane);
  int8_t* wobs = obs + b0 * OBS;
  const int full = m * OBS / 16;
  for (int j = lane; j < m * kWinWords; j += 32) {
    const int e = j / kWinWords;
    const int w = (e * OBS + kWinLo) / 16 + j % kWinWords;
    if (w > (e * OBS + kWinHi - 1) / 16 || w >= full) continue;
    if (e > 0 && w <= ((e - 1) * OBS + kWinHi - 1) / 16) continue;  // the env before writes it
    const uint32_t bits = piece_bits(16 * w, e, wm, m);
    reinterpret_cast<uint4*>(wobs)[w] = make_uint4(spread4(bits & 15u) * 0xFFu, spread4((bits >> 4) & 15u) * 0xFFu,
                                                  spread4((bits >> 8) & 15u) * 0xFFu, spread4(bits >> 12) * 0xFFu);
  }
  for (int g = 16 * full + lane; g < m * OBS; g += 32) {
    const int e = g / OBS, c = g - e * OBS, r = c / WIDTH, col = c - r * WIDTH - kWinC0;
    const bool on = r < kWinRows && col >= 0 && col < 8 && ((wm[e] >> (8 * r + col)) & 1u);
    wobs[g] = on ? static_cast<int8_t>(-1) : static_cast<int8_t>(0);
  }
}

// reset for a block of up to E envs (kernels.py:fn_reset_shape: E =
// min(kResetMaxEnvs, ceil(B / SMs)) rounded up to kEnvAlign), kResetThreads
// threads, no block-wide barrier.  The board tensor is B copies of one
// pattern known at compile time and the observation is zeros but for the
// spawned pieces' cells: the warps of the block's envs (at most four) each
// reset their envs (reset_warp) while the other warps stream their share of
// both tensors as 16-byte words (stream_reset).  (Every thread streaming
// first, then the chains, was 10-27% slower at B = 8192 and 65536.)
__global__ void __launch_bounds__(kResetThreads) fn_reset_kernel(const uint32_t* __restrict__ keys,
                                                              uint32_t* __restrict__ keys_out, FnPtrs out,
                                                              int8_t* __restrict__ obs,
                                                              const uint64_t* __restrict__ masks, int B,
                                                              int E, int uniform) {
  __shared__ __align__(16) int32_t tiles[kResetWarps][32 * QS];
  __shared__ uint64_t wmasks[kResetWarps][32];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long base = static_cast<long long>(blockIdx.x) * E;
  const int n = static_cast<int>(min(static_cast<long long>(E), B - base));
  const int env_warps = (n + 31) / 32;  // at most kResetMaxEnvs / 32 = 4
  const int first = 32 * env_warps;     // the first streaming thread
  if (warp < env_warps)
    reset_warp(keys, keys_out, out, obs, masks, base + 32 * warp, min(32, n - 32 * warp), lane, uniform != 0,
               tiles[warp], wmasks[warp]);
  else
    stream_reset(out.board + base * CELLS, obs + base * OBS, n, t - first, kResetThreads - first);
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

// Envs a block of the reset for a batch of B: as many as give every SM a
// block where B gives the SMs fewer than kResetMaxEnvs each, rounded up to
// whole words of both tensors.
int reset_envs(int B) {
  const int per_sm = (B + sm_count() - 1) / sm_count();
  const int E = per_sm < kResetMaxEnvs ? per_sm : kResetMaxEnvs;
  return (E + kEnvAlign - 1) / kEnvAlign * kEnvAlign;
}

// The step's two builds: params->bulk picks the bulk copies of the boards
// (kernels.py:fn_step_build).  Shared memory past 48 KB is opted into once.
template <bool kBulk>
int launch_step(const FnPtrs* in, const FnPtrs* out, const void* action, void* obs, void* reward,
                void* terminated, void* lines, const void* masks, const void* ids, int B,
                const FnParams* params, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(
      fn_step_kernel<kBulk>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStepSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  fn_step_kernel<kBulk><<<(B + kStepEnvs - 1) / kStepEnvs, kStepThreads, kStepSmem, stream>>>(
      *in, *out, static_cast<const int32_t*>(action), static_cast<int8_t*>(obs),
      static_cast<float*>(reward), static_cast<uint8_t*>(terminated), static_cast<int32_t*>(lines),
      static_cast<const uint64_t*>(masks), static_cast<const int32_t*>(ids), B, *params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fn_step_launch(const FnPtrs* in, const FnPtrs* out, const void* action, void* obs,
                              void* reward, void* terminated, void* lines, const void* masks,
                              const void* ids, int B, const FnParams* params, void* stream) {
  auto* launch = params->bulk ? launch_step<true> : launch_step<false>;
  return launch(in, out, action, obs, reward, terminated, lines, masks, ids, B, params,
                static_cast<cudaStream_t>(stream));
}

// Blocks of the step's build an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// and its envs a block, threads a block and dynamic shared memory.
extern "C" int fn_step_occupancy(int bulk, int* blocks, int* envs, int* threads, int* smem) {
  *envs = kStepEnvs;
  *threads = kStepThreads;
  *smem = kStepSmem;
  const void* kernel = bulk ? reinterpret_cast<const void*>(fn_step_kernel<true>)
                            : reinterpret_cast<const void*>(fn_step_kernel<false>);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStepSmem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kStepThreads, kStepSmem);
  return static_cast<int>(rc);
}

// keys, keys_out and out->rng_key: uint32[B, 2] on 8 bytes; out->board and
// obs on 16 bytes (else cudaErrorMisalignedAddress).
extern "C" int fn_reset_launch(const void* keys, void* keys_out, const FnPtrs* out, void* obs,
                               const void* masks, int B, int uniform, void* stream) {
  if (((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(keys_out) |
        reinterpret_cast<uintptr_t>(out->rng_key)) & 7u) ||
      ((reinterpret_cast<uintptr_t>(out->board) | reinterpret_cast<uintptr_t>(obs)) & 15u))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int E = reset_envs(B);
  fn_reset_kernel<<<(B + E - 1) / E, kResetThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(keys_out), *out,
      static_cast<int8_t*>(obs), static_cast<const uint64_t*>(masks), B, E, uniform);
  return static_cast<int>(cudaGetLastError());
}

// The reset's shape for a batch of B: out = [envs a block, threads a block,
// blocks, the multiple of envs a block that makes both tensors whole words].
extern "C" int fn_reset_shape(int B, int* out) {
  out[0] = reset_envs(B);
  out[1] = kResetThreads;
  out[2] = (B + out[0] - 1) / out[0];
  out[3] = kEnvAlign;
  return 0;
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
