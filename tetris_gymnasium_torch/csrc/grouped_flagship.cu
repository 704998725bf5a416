// Placements and the grouped observation of the flagship engine for Hopper
// (sm_90a): one thread per (env, candidate), on id boards.
//
// Replaces tetris_gymnasium_tpu/core/grouped.py:placements (:98) with
// _candidate (:68) and _frame_overlap (:57) over the one-hot
// ops/board.py:drop_distance (:116), collision (:62), project (:80) and
// clear_lines (:166), and grouped_observation (:113) in its boards and
// features modes (feature_vector, ops/observations.py:57).  For each of the
// A = 40 (column, rotation) candidates of every env it drops the active
// piece from the top, tests the resting window against the bedrock frame
// (id 1 under a piece cell: illegal) and the stack (a cell > 0: a legal
// game-over placement), locks the piece by ADDING its id into the window
// (int8 wrap), clears every full row (no envelope) and writes:
//   mode 0, features: float32[B, A, n] of the cropped cleared board, under
//     any FeatureFlags (features.cuh);
//   mode 1, boards: float32[B, A, 24, 18] padded id boards;
//   mode 2, ids: the same boards as int8 (the grouped rgb mode views them
//     as uint8 and composites them with compose_rgb).
// An illegal candidate's board is all ones, its padding too (features:
// heights 20, max 20, holes 0, bumpiness 0); a game-over one's all zeros.
// Every mode writes mask float32[B, A], game_over bool[B, A] and lines
// int32[B, A].  The plain PyTorch twins are
// tetris_gymnasium_torch/core/grouped.py:placements_plain and
// grouped_observation_plain; every output is bit-equal to them.
//
// On the TPU each candidate is a vmapped lane of one-hot contractions, with
// 40 boards of an env materialised in HBM and cleared by a [20, 20]
// permutation matmul.  Here a block takes 6 envs: it stages their boards
// (432 bytes each) in shared memory with 16-byte loads and packs each into
// 24 occupancy words once (engine_common.cuh, as flagship_step.cu does);
// each thread runs the flagship step's bit logic on its candidate (hit map,
// drop, collision), sums only the 4 rows of the piece's window cell by cell
// and keeps nothing of its board but the 20-bit mask of full rows, the
// window rows' filled cells and, for the board modes, the source row of
// each output row in shared memory.  The features mode folds the rows that
// stay into the height counters as 10-bit masks: window rows from its sums,
// the others straight from the staged rows' filled-cell words.  The block
// then writes its 240 candidates' outputs, which are contiguous, together:
// 16-byte stores (4-byte for ids), neighbouring threads on neighbouring
// words, each cell read back from the staged board with the piece's id
// added where the piece lies.
//
// Bound on this card: bytes in the board modes (an env writes 69,120 bytes
// of float32 boards, 17,280 of ids), operations in features mode (~40 x
// ~850 integer operations an env against 40 * 4 * 13 + 360 bytes).
//
// Geometry is the default EngineConfig (24x18 padded board, 7 pieces of
// side <= 4): the header's default build, single-word rows and piece
// entries; the wrapper refuses others.

#include <cstdint>
#include <cuda_runtime.h>

#include "engine_common.cuh"
#include "features.cuh"

using namespace engine;
static_assert(NW == 1 && TW == 1, "grouped_flagship is built for the default geometry");

namespace {

constexpr int A = WIDTH * 4;      // candidates an env
constexpr int kEnvs = 6;          // envs a block
constexpr int kThreads = kEnvs * A;
constexpr int BOARD = H * PW;     // 432 bytes
constexpr int kMaxFeatures = features::FW + 3;
enum : int { kFeatures = 0, kBoards = 1, kIds = 2 };
enum : int { kPlaced = 0, kIllegal = 1, kOver = 2 };

// Cell (r, c) of an env's board after its candidate's lock and clear, given
// where the output row came from (src < 0: a cleared row, zeros).
__device__ __forceinline__ int8_t cleared_cell(const int8_t* bd, int src, int c, uint32_t word, int xc,
                                               int yc, int pid) {
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
  __shared__ uint32_t srows[kEnvs * H];          // occupancy (> 0) of each padded row
  __shared__ uint32_t snz[kEnvs * H];            // filled cells (!= 0) of each padded row
  __shared__ int8_t ssrc[kThreads * HEIGHT];     // source row of each output row
  __shared__ int sstatus[kThreads], sword[kThreads], sxc[kThreads], syc[kThreads], spid[kThreads];
  __shared__ float sfeat[kThreads * kMaxFeatures];

  const int b0 = blockIdx.x * kEnvs;
  const int n_env = min(kEnvs, B - b0);
  block_copy16(sboard, boards + static_cast<size_t>(b0) * BOARD, n_env * BOARD);
  __syncthreads();
  for (int i = threadIdx.x; i < n_env * H; i += blockDim.x) {
    const int8_t* row = sboard + i * PW;  // env i / H, row i % H
    uint32_t r = 0, nz = 0;
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      r |= (row[w] > 0 ? 1u : 0u) << w;
      nz |= (row[w] != 0 ? 1u : 0u) << w;
    }
    srows[i] = r;
    snz[i] = nz;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int e = t / A, a = t % A;
  const int n_feat = features::n_features(flags);
  if (e < n_env) {
    const int b = b0 + e;
    const int8_t* bd = sboard + e * BOARD;
    Rows rows;
#pragma unroll
    for (int h = 0; h < H; ++h) rows[h][0] = srows[e * H + h];

    // -- the candidate (_candidate :68): rotation, column, drop from the top
    const int piece = piece_in[b];
    int rot = (rotation_in[b] + (a & 3)) % 4;
    if (rot < 0) rot += 4;
    const PieceWord pword = piece_word_2d(packed, piece, rot);
    const uint32_t word = pword.w[0];
    const int x = a / 4 + PAD - piece_entry(box, piece) / 2;
    const HitMask hm = hit_map(rows, pword, x);
    const int y = drop_from_map(hm, 0);
    const int xc = clamp_start(x, PW - S, PW);
    const int yc = clamp_start(y, H - S, H);
    const int pid = piece_entry(ids, piece);

    bool frame_hit = false;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const uint32_t prow = piece_row(word, i);
#pragma unroll
      for (int j = 0; j < S; ++j)
        frame_hit |= ((prow >> j) & 1u) && bd[(yc + i) * PW + xc + j] == 1;
    }
    const bool stack_hit = collision_at(hm, y);

    // -- lock and clear: the full rows of the stamped board.  The S rows of
    //    the piece's window are summed cell by cell (their filled playfield
    //    cells kept as 10-bit masks in `win`); the others are the staged rows
    uint32_t filled = 0;
    uint64_t win = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int h = yc + i;
      const uint32_t prow = piece_row(word, i);
      uint32_t pos = 0, nz = 0;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) {
        const int j = PAD + c - xc;
        int v = bd[h * PW + PAD + c];
        if (j >= 0 && j < S && ((prow >> j) & 1u)) v += pid;
        pos |= (static_cast<int8_t>(v) > 0 ? 1u : 0u) << c;
        nz |= (static_cast<int8_t>(v) != 0 ? 1u : 0u) << c;
      }
      win |= static_cast<uint64_t>(nz) << (WIDTH * i);
      if (h < HEIGHT && pos == features::ROW_MASK) filled |= 1u << h;
    }
#pragma unroll
    for (int h = 0; h < HEIGHT; ++h)
      if (h < yc || h >= yc + S) filled |= (row_full(rows[h]) ? 1u : 0u) << h;
    const int n = __popc(filled);
    const int status = frame_hit ? kIllegal : (stack_hit ? kOver : kPlaced);
    const long long ab = static_cast<long long>(b) * A + a;
    mask[ab] = frame_hit ? 0.0f : 1.0f;
    game_over[ab] = status == kOver ? 1 : 0;
    lines_out[ab] = status == kPlaced ? n : 0;

    if (mode == kFeatures) {
      features::Acc acc;
      acc.init();
      if (status == kIllegal) {
        for (int d = 0; d < HEIGHT; ++d) acc.add_row(features::ROW_MASK);
      } else if (status == kPlaced) {
        // the rows that stay, top-down (the cleared rows above them are
        // zeros): a window row's mask, or the staged row's filled cells
        const uint32_t* nz = snz + e * H;
#pragma unroll
        for (int h = 0; h < HEIGHT; ++h) {
          if ((filled >> h) & 1u) continue;
          const int i = h - yc;
          acc.add_row(i >= 0 && i < S ? static_cast<uint32_t>(win >> (WIDTH * i)) & features::ROW_MASK
                                      : (nz[h] >> PAD) & features::ROW_MASK);
        }
      }
      acc.write(flags, sfeat + t * n_feat);
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
      sword[t] = static_cast<int>(word);
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
    float* out = static_cast<float*>(obs) + first * n_feat;
    for (int i = threadIdx.x; i < n_cand * n_feat; i += blockDim.x) out[i] = sfeat[i];
    return;
  }
  auto cell = [&](int i) -> int8_t {  // cell i of the block's boards
    const int c = i / BOARD, rem = i % BOARD;
    const int r = rem / PW, col = rem % PW;
    if (sstatus[c] == kIllegal) return 1;
    if (sstatus[c] == kOver) return 0;
    const int src = r < HEIGHT ? ssrc[c * HEIGHT + r] : HEIGHT;
    return cleared_cell(sboard + (c / A) * BOARD, src, col, static_cast<uint32_t>(sword[c]), sxc[c],
                        syc[c], spid[c]);
  };
  if (mode == kBoards) {  // 16-byte stores: BOARD floats is a multiple of 4
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(obs) + first * BOARD);
    for (int i = threadIdx.x; i < n_cand * BOARD / 4; i += blockDim.x)
      out[i] = make_float4(cell(4 * i), cell(4 * i + 1), cell(4 * i + 2), cell(4 * i + 3));
  } else {  // 4-byte stores of 4 ids
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

// boards: int8[B, 24, 18] (16-byte aligned); piece, rotation: int32[B];
// packed: uint32[28]; box, ids: int32[7]; obs: float32[B, A, n] (mode 0),
// float32[B, A, 24, 18] (mode 1) or int8[B, A, 24, 18] (mode 2); mask:
// float32[B, A]; game_over: bool[B, A]; lines: int32[B, A].
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
