// Placement enumeration of the turbo grouped engine for Hopper (sm_90a):
// one thread per (env, candidate).
//
// Replaces tetris_gymnasium_tpu/core/turbo_grouped.py:_candidate_rows (:103)
// with _features_from_rows (:65), placements (:152) and placement_boards
// (:177).  For each of the A = width * 4 (column, rotation) candidates of
// every env it drops the active piece from the top, tests the resting
// position against the bedrock frame (illegal) and the stack (game over),
// locks it, clears full rows with the same max_clear envelope as
// core/turbo.py:_clear_lines (more than max_clear full rows make a game-over
// placement), and reduces the board to the candidate's observation:
//   mode 0, features: float32[B, A, width + 3] (column heights, max height,
//     holes, bumpiness), written in the layout the network reads, so the
//     JAX transpose at turbo_grouped.py:226 goes away; illegal candidates get
//     the all-ones board's features, game-over candidates zeros;
//   mode 1, boards: float32[B, A, height, width] binary boards, all ones for
//     an illegal candidate and all zeros for a game-over one.
// Both modes write the mask float32[A, B] (1 = legal), game_over bool[A, B]
// and lines int32[A, B], batch-minor as the engine keeps them.  The plain
// PyTorch twins are tetris_gymnasium_torch/core/turbo_grouped.py:
// placements_plain and placement_boards_plain; every output is bit-equal.
//
// On the TPU this is vector code over [H, A, B] tiles: every candidate board
// is materialised, stamped, compacted by max_clear + 1 static shifts and
// unpacked.  Here a block stages the packed rows of its envs in shared
// memory once (each row is read by the A threads of its env) and each thread
// keeps nothing of its candidate board but the 64-bit mask of full rows:
//   - the hit map over every window start is one 64-bit mask;
//   - a stamped row is the staged row OR the piece row that lands on it;
//   - the compaction keeps the order of the rows that stay and packs them to
//     the bottom (a row moves down by the full rows below it), so the
//     non-empty rows of the cleared board come out top-down in one pass with
//     no gaps and no scratch board;
//   - column heights come from bit-sliced counters: adding the running OR of
//     the rows seen so far into six bit planes counts, for every column at
//     once, the rows at or below its top, which is its height; holes are the
//     sum of the heights less the occupied cells;
//   - each thread leaves its observation in shared memory (13 floats, or 20
//     packed rows for a board) and the block then writes its candidates'
//     observations, which are contiguous in obs, together: consecutive
//     threads store consecutive words (16-byte stores for boards), where one
//     thread writing its own 800-byte board would leave every store of a warp
//     800 bytes from the next.
//
// Bound on this card: operations in features mode, bytes in boards mode.  A
// candidate costs ~(H - 3) * 8 integer operations for the hit map, ~6 * height
// for the full-row mask and ~20 * height for the compaction and counters, and
// writes 4 * (width + 3) + 9 bytes (features) or 4 * height * width + 9
// (boards).  Geometry comes in at run time, as for observe_board, so the test
// configurations (6x8, 7x12) take the same code path as the default 10x20.
// The piece box must be 4x4 (the 7 standard pieces); the wrapper refuses
// others, and padded boards of more than 64 rows or 32 columns.

#include <cstdint>
#include <cuda_runtime.h>

struct GroupedGeometry {
  int height;        // playfield rows
  int width;         // playfield columns
  int padding;       // bedrock columns on each side and rows below
  int rows_h;        // padded height H of the rows array, at most 64
  int padded_width;  // width + 2 * padding, at most 32
  int n_entries;     // entries of the packed table (n_pieces * 4)
  int n_pieces;      // entries of the box table
  int n_actions;     // A = width * 4
  int max_clear;     // compaction envelope
  int mode;          // 0 features, 1 boards
};

namespace {

constexpr int S = 4;  // piece box side
constexpr int kPlanes = 6;  // bit planes of the height counters: heights up to 63

__device__ __forceinline__ int clamp_start(int v, int limit, int dim) {
  if (v < 0) v += dim;
  return min(max(v, 0), limit);
}

// Row k (0..S-1) of the packed piece word, shifted to column xc.
__device__ __forceinline__ uint32_t piece_row(uint32_t word, int k, int xc) {
  return ((word >> (k * S)) & ((1u << S) - 1u)) << xc;
}

// One candidate: drop, legality, lock, clear; writes its mask, game-over and
// lines, and its observation into the block's staging area `stage`:
// features, width + 3 floats; boards, `height` packed playfield rows (all
// playfield bits for an illegal candidate, none for a game-over one).
__device__ __forceinline__ void evaluate_candidate(
    const uint32_t* r, int E, int p, int rotation, int a, long long ab,
    const uint32_t* __restrict__ packed, const int32_t* __restrict__ box, uint32_t* stage,
    float* __restrict__ mask, uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out,
    const GroupedGeometry& g) {
  const int H = g.rows_h;
  const int pw = g.padded_width;
  const uint32_t pm = ((1u << g.width) - 1u) << g.padding;
  const uint32_t side = ((1u << g.padding) - 1u) | (((1u << g.padding) - 1u) << (g.padding + g.width));
  const uint32_t full = pw == 32 ? 0xFFFFFFFFu : (1u << pw) - 1u;

  // -- candidate geometry (_candidate_geometry :93)
  int rot = (rotation + (a & 3)) % 4;
  if (rot < 0) rot += 4;
  const int bx = (p >= 0 && p < g.n_pieces) ? __ldg(box + p) : 0;
  const int x = a / 4 + g.padding - bx / 2;
  const int idx = p * 4 + rot;
  const uint32_t word = (idx >= 0 && idx < g.n_entries) ? __ldg(packed + idx) : 0u;
  const int xc = clamp_start(x, pw - S, pw);
  const uint32_t sp0 = piece_row(word, 0, xc), sp1 = piece_row(word, 1, xc);
  const uint32_t sp2 = piece_row(word, 2, xc), sp3 = piece_row(word, 3, xc);

  // -- drop from the top: hit map over the window starts 0..H-S, bit y
  uint64_t hm = 0;
  for (int y = 0; y <= H - S; ++y) {
    const uint32_t acc = (r[y * E] & sp0) | (r[(y + 1) * E] & sp1) | (r[(y + 2) * E] & sp2) |
                         (r[(y + 3) * E] & sp3);
    hm |= static_cast<uint64_t>(acc != 0u) << y;
  }
  const int z = min(1, H - S);
  const uint64_t eligible = hm & (~0ull << z);
  const int first_hit = eligible ? __ffsll(static_cast<long long>(eligible)) - 1 : 2 * H;
  const int y_rest = first_hit == 0 ? 0 : min(max(first_hit - 1, 0), H);
  const int yc = clamp_start(y_rest, H - S, H);

  // -- legality against the bedrock frame, game over against the stack
  bool frame_hit = false;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t bed = yc + k < g.height ? side : full;
    frame_hit |= (bed & piece_row(word, k, xc)) != 0u;
  }
  bool stack_hit = ((hm >> yc) & 1ull) && !frame_hit;

  // -- lock and find the full rows; row h of the stamped board is
  //    r[h] | (the piece row landing on h)
  auto stamped = [&](int h) -> uint32_t {
    const int k = h - yc;
    return r[h * E] | (k >= 0 && k < S ? piece_row(word, k, xc) : 0u);
  };
  uint64_t filled = 0;
  for (int h = 0; h < g.height; ++h)
    filled |= static_cast<uint64_t>((stamped(h) & pm) == pm) << h;
  const int n = __popcll(filled);
  stack_hit |= n > g.max_clear;

  mask[ab] = frame_hit ? 0.0f : 1.0f;
  game_over[ab] = stack_hit ? 1 : 0;
  lines_out[ab] = (frame_hit || stack_hit) ? 0 : n;

  if (g.mode == 0) {
    float* o = reinterpret_cast<float*>(stage);
    if (stack_hit || frame_hit) {
      const float v = stack_hit ? 0.0f : static_cast<float>(g.height);
      for (int w = 0; w <= g.width; ++w) o[w] = v;
      o[g.width + 1] = 0.0f;
      o[g.width + 2] = 0.0f;
      return;
    }
    // non-empty rows of the cleared board, top-down: every row that stays and
    // moves by at most max_clear, in order
    uint32_t planes[kPlanes] = {0u, 0u, 0u, 0u, 0u, 0u};
    uint32_t seen = 0u;
    int occupied = 0;
    int cum = 0;  // full rows at or above h
    for (int h = 0; h < g.height; ++h) {
      const int f = static_cast<int>((filled >> h) & 1ull);
      cum += f;
      if (f || n - cum > g.max_clear) continue;
      const uint32_t row = stamped(h) & pm;
      seen |= row;
      occupied += __popc(row);
      uint32_t carry = seen;  // one more row at or below the top, for every column seen
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) {
        const uint32_t t = planes[j] & carry;
        planes[j] ^= carry;
        carry = t;
      }
    }
    int max_h = 0, sum_h = 0, bump = 0, prev = 0;
    for (int w = 0; w < g.width; ++w) {
      const int col = g.padding + w;
      int hw = 0;
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) hw |= static_cast<int>((planes[j] >> col) & 1u) << j;
      o[w] = static_cast<float>(hw);
      max_h = max(max_h, hw);
      sum_h += hw;
      if (w) bump += abs(hw - prev);
      prev = hw;
    }
    o[g.width] = static_cast<float>(max_h);
    o[g.width + 1] = static_cast<float>(sum_h - occupied);
    o[g.width + 2] = static_cast<float>(bump);
    return;
  }

  // boards: the cleared playfield rows, top-down
  if (stack_hit || frame_hit) {
    for (int d = 0; d < g.height; ++d) stage[d] = stack_hit ? 0u : pm;
    return;
  }
  int next = 0;  // next output row to write
  int cum = 0;
  for (int h = 0; h < g.height; ++h) {
    const int f = static_cast<int>((filled >> h) & 1ull);
    cum += f;
    if (f || n - cum > g.max_clear) continue;
    const int d = h + n - cum;
    for (; next < d; ++next) stage[next] = 0u;
    stage[d] = stamped(h) & pm;
    next = d + 1;
  }
  for (; next < g.height; ++next) stage[next] = 0u;
}

__global__ void grouped_placements_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ piece,
    const int32_t* __restrict__ rotation, const uint32_t* __restrict__ packed,
    const int32_t* __restrict__ box, float* __restrict__ obs, float* __restrict__ mask,
    uint8_t* __restrict__ game_over, int32_t* __restrict__ lines_out, int B, GroupedGeometry g) {
  // shared: the envs' packed rows [rows_h][E], then one staging slot per
  // candidate (features: width + 3 floats; boards: height row words)
  extern __shared__ uint32_t smem[];
  const int A = g.n_actions;
  const int E = blockDim.x / A;  // envs per block
  const int b0 = blockIdx.x * E;
  const int slot = g.mode == 0 ? g.width + 3 : g.height;
  uint32_t* staged = smem;
  uint32_t* stage = smem + E * g.rows_h;
  for (int i = threadIdx.x; i < E * g.rows_h; i += blockDim.x) {
    const int h = i / E, e = i % E;
    staged[i] = b0 + e < B ? rows[static_cast<long long>(h) * B + b0 + e] : 0u;
  }
  __syncthreads();
  const int e = threadIdx.x / A;
  const int a = threadIdx.x % A;
  const int b = b0 + e;
  if (b < B)
    evaluate_candidate(staged + e, E, piece[b], rotation[b], a, static_cast<long long>(a) * B + b,
                       packed, box, stage + threadIdx.x * slot, mask, game_over, lines_out, g);
  __syncthreads();

  // The block's candidates are contiguous in obs: write them together, so
  // that consecutive threads store consecutive words.
  const int n_cand = min(E, B - b0) * A;
  const long long first = static_cast<long long>(b0) * A;
  if (g.mode == 0) {
    float* out = obs + first * slot;
    const float* src = reinterpret_cast<const float*>(stage);
    for (int i = threadIdx.x; i < n_cand * slot; i += blockDim.x) out[i] = src[i];
    return;
  }
  const int cells = g.height * g.width;
  float* out = obs + first * cells;
  auto cell = [&](int i) -> float {  // float i of the block's boards
    const int c = i / cells, rem = i % cells;
    const uint32_t row = stage[c * g.height + rem / g.width];
    return static_cast<float>((row >> (g.padding + rem % g.width)) & 1u);
  };
  if (cells % 4 == 0) {  // 16-byte stores: the block's first float is 16-byte aligned
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int i = threadIdx.x; i < n_cand * cells / 4; i += blockDim.x)
      out4[i] = make_float4(cell(4 * i), cell(4 * i + 1), cell(4 * i + 2), cell(4 * i + 3));
  } else {
    for (int i = threadIdx.x; i < n_cand * cells; i += blockDim.x) out[i] = cell(i);
  }
}

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;  // without opting in to more

}  // namespace

// rows: uint32[rows_h, B]; piece, rotation: int32[B]; packed: uint32[n_entries];
// box: int32[n_pieces]; obs: float32[B, A, width + 3] or [B, A, height, width];
// mask: float32[A, B]; game_over: bool[A, B]; lines: int32[A, B].
extern "C" int grouped_placements_launch(const void* rows, const void* piece,
                                         const void* rotation, const void* packed,
                                         const void* box, void* obs, void* mask,
                                         void* game_over, void* lines, int B,
                                         const GroupedGeometry* geometry, void* stream) {
  const GroupedGeometry g = *geometry;
  const int slot = g.mode == 0 ? g.width + 3 : g.height;
  const size_t per_env = (g.rows_h + static_cast<size_t>(g.n_actions) * slot) * sizeof(uint32_t);
  const int envs_per_block =
      max(1, min(kMaxThreads / g.n_actions, static_cast<int>(kMaxSmem / per_env)));
  const int threads = envs_per_block * g.n_actions;
  const int blocks = (B + envs_per_block - 1) / envs_per_block;
  const size_t smem = envs_per_block * per_env;
  grouped_placements_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int32_t*>(piece),
      static_cast<const int32_t*>(rotation), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(box), static_cast<float*>(obs), static_cast<float*>(mask),
      static_cast<uint8_t*>(game_over), static_cast<int32_t*>(lines), B, g);
  return static_cast<int>(cudaGetLastError());
}
