// The device replay buffer's block write and its samples for Hopper (sm_90a).
//
// Replaces tetris_gymnasium_tpu/rl/buffers.py:add (:46), sample (:64),
// sample_with_next (:70) and sample_with_next_stacked (:111).  The buffer is
// a struct of arrays, one [capacity, ...] store per field (obs, mask, action,
// reward, done for the grouped DQN; obs, action, reward, done for the CNN
// DQN); the plain PyTorch twins are tetris_gymnasium_torch/rl/buffers.py:
// add_plain, sample_plain, sample_with_next_plain and
// sample_with_next_stacked_plain, and every output is bit-equal to them.
//
// replay_add: one launch writes one env batch into every field at entry pos
// (a multiple of the batch, so the destination [pos, pos + B) of each store
// is contiguous).  A source row may lie at any stride (the newest frame of
// the DQN's [B, K, H, W] window is a strided [B, H, W] view), so no
// contiguous copy is made first.  A field may also come batch-minor, [n, B]
// of 4-byte elements seen as [B, n] (the engine's [A, B] mask): the kernel
// transposes it as it writes.  The grid is one flat run of blocks that the
// launcher apportions to the fields by their bytes (AddPlan), so that no
// block is launched for nothing; each block copies its field's share:
//   words: the 16-, 4- or 1-byte words that the field's entry size,
//     alignment and source row stride allow, one a thread in runs of
//     kThreads words, the row of a word found by one 32-bit division; a
//     field takes at most kAddMaxRuns blocks, each every kAddMaxRuns-th run
//     (2 and 4 loads in flight a thread were slower at the paths' batches);
//   transposed: a 32 x 32 tile through shared memory (32 x 33 words, so
//     that neither the column reads nor the row writes share a bank), the
//     source read along b and the store written along its rows, both
//     coalesced.
// Runs of rows staged and stored by bulk copies (cp.async.bulk, one thread
// a block) were slower at the DQN paths' batches (PERF.md): each
// block is one serial round trip.
//
// replay_sample: one launch draws JAX's randint(key, (n,), 0, span) on the
// card (threefry.cuh; the host splits the key and passes span and the
// multiplier, 2**16 % span squared in uint32, mod span), forms idx = (start + off) mod
// capacity and, for sample_with_next, nxt = (idx + batch) mod capacity, and
// gathers the entry (and its successor) of every field.  No index crosses
// from the host, and one launch replaces a gather per field.  The fields'
// words of the entry and the successor, laid end to end (widest words
// first), are one item map (SamplePlan; no division runs a word).  A unit,
// a chunk of a sample's items, goes to a group of 8, 16 or 32 lanes: a
// warp while the samples' warps fit 16 an SM (a small n is a chain of
// latencies that more lanes shorten), narrower for a large n (the CNN
// DQN's 209-byte entries: 8 lanes, four samples a warp), and 4 words a
// lane while the units still fit, else 16 (one chunk, one draw, a sample).
// The group's first lane draws (both threefry blocks, the remainders by
// Lemire's multiply) and shuffles the entry and successor to the group;
// each lane loads its words into registers, reading each field from the
// parameters, before it stores any.  No shared memory, no barrier.  The
// first design (256 threads on 4 samples, the draw by 4 threads behind a
// barrier, the fields one after another, each word a load then its store)
// kept one or two loads in flight a thread; designs with a field table in
// shared memory, or the rows staged by cp.async, were slower (PERF.md).
//
// replay_sample_stacked: replay_sample with successors whose observation
// field comes back as K-frame windows [n, K, ...], rebuilt from the single
// frames the buffer stores (the same env's previous frame is batch entries
// earlier).  The host folds the (K - 1) * batch entries that sampling skips
// into start.  For an anchor a (the entry and its successor), the lookback
// depth m is the number of the done flags of transitions a - j * batch, j =
// 1 .. K - 1, before the first set one; frame j (newest first) is entry (a
// - min(j, m) * batch) mod capacity, written oldest first.  So a window
// never crosses into a previous episode: its deeper frames repeat the
// episode's first one.  A warp takes a sample (stage_map below): it loads
// the K flags that both windows read at once, a lane each, and takes both
// depths from one ballot; the two windows use at most K + 1 distinct
// entries.  Two builds, picked by kernels.py:replay_stacked_build:
//   bulk (an obs row of a multiple of 16 bytes on 16-byte boundaries, K + 1
//     rows within 200 KB, the pixel DQN's 7056-byte frames): a block of one
//     warp; lane 0 stages the <= K + 1 distinct frames in shared memory
//     with one cp.async.bulk each on one mbarrier, then writes the 2K
//     output frames with bulk stores, while the other lanes copy the other
//     fields.  The first design (a block of 256 threads on 4 samples, one
//     16-byte word a thread an iteration, a 64-bit / and % each, the store
//     waiting on its load) held ~4 KB in flight an SM: 29% of the bound at
//     n = 512.  Here each sample's K + 1 frames (35 KB at K = 4) are in
//     flight at once and no division runs in a per-word loop;
//   words (any other row, the board DQN's 200-byte int8 frames): a warp a
//     sample, 4 samples a block, each output frame copied in the field's
//     words straight from the store, four frames' loads in flight before
//     their stores.
//
// Bound on this card: bytes, and at the DQN's shapes launch latency.  add
// moves B entries in and out (2 * 2,249 bytes an env for the grouped
// features: obs 40 * 13 * 4, mask 40 * 4, action 4, reward 4, done 1;
// 2 * 209 bytes for the CNN DQN's boards); sample moves 2 * n entries out and
// reads as many; the stacked sample writes 2 * n * K frames and the other
// fields of 2 * n entries, and reads at most K + 1 distinct frames, K + 1
// done flags and the other fields of 2 entries a sample (the successor's
// window shares K - 1 frames with the entry's), fewer where a window repeats
// an episode's first frame or samples share entries.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "threefry.cuh"

constexpr int kMaxFields = 8;

struct ReplayField {
  void* store;          // [capacity, ...]
  const void* src;      // replay_add: the batch, [B, ...] (or [n, B] when transposed)
  void* out_cur;        // replay_sample: [n_samples, ...]
  void* out_nxt;        // replay_sample: successors [n_samples, ...], or null
  long long row_bytes;  // bytes of one entry
  long long src_stride; // replay_add: bytes from one source row to the next
  int word;             // copy granule: 16, 4 or 1 bytes
  int transposed;       // replay_add: the source is batch-minor 4-byte elements
};

struct ReplayFields {
  ReplayField f[kMaxFields];
  int n;
};

struct SampleParams {
  uint32_t hi_k0, hi_k1;  // first half of the split key (high draw)
  uint32_t lo_k0, lo_k1;  // second half (low draw)
  uint32_t span;          // randint's maxval, at least 1
  uint32_t multiplier;    // (2**16 % span)**2 % span, the square wrapping in uint32
  long long start;        // oldest entry
  long long capacity;
  long long batch;        // successor distance; 0 without successors
  int n;                  // samples
};

struct StackParams {
  const bool* done;  // the done store, bool[capacity]
  int obs_field;     // index of the field gathered as windows
  int k;             // frames a window, 1 .. kMaxStack
  int bulk;          // the bulk build: the obs field's frames staged by cp.async.bulk
};

// replay_add's grid: the first block of each field (first[n] is the
// grid's size).
struct AddPlan {
  int first[kMaxFields + 1];
};

// replay_sample's plan (replay_sample_kernel).  A sample's item map: its
// fields' words of the entry, then of the successor, field by field, at
// table positions 0 .. n - 1 (16-byte words first, then 4-byte, then single
// bytes): position t's field has wpr[t] words a row and items first[t] ..
// first[t + 1] - 1 (first past the last field is items).
// A unit is a chunk of chunk_items consecutive items of one sample, taken
// by a group of group lanes; a block takes units_per_block samples' unit of
// chunk blockIdx.y, of chunks a sample.  The fields come to the kernel in
// table order (SampleFields).
// span_magic is Lemire's constant for x mod span (2**64 - 1) / span + 1;
// wrap_once where every offset and the batch lie below the capacity.
struct SamplePlan {
  int first[kMaxFields + 1];
  int wpr[kMaxFields];
  int items;
  int group;
  int slots;  // chunk_items / group: a lane's words in flight
  int chunk_items;
  int chunks;
  int units_per_block;
  int wrap_once;
  unsigned long long span_magic;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroupThreads = 256;  // replay_sample: most threads a block
constexpr int kSlotsFew = 4;           // replay_sample: a lane's words for a small n (short chains)
constexpr int kSlotsMany = 16;         // ... and for a large one (one draw a sample)
constexpr int kWarpsPerSM = 16;        // replay_sample: groups widen, and chunks shrink, while the warps fit this
constexpr int kMaxStack = 16;
constexpr int kAddMaxRuns = 32768;       // words: blocks a field
constexpr int kTile = 32;                // transposed: a 32 x 32 tile, 8 rows of it a pass

// The field's batch in runs of kThreads words, runs block, block + blocks,
// ...: word i is word i - row * wpr of row i / wpr; the source rows lie
// src_wpr words apart.
template <typename T>
__device__ __forceinline__ void add_words(const ReplayField& f, char* dst, int block, int blocks,
                                          int B) {
  const uint32_t wpr = static_cast<uint32_t>(f.row_bytes / static_cast<long long>(sizeof(T)));
  const uint32_t n = static_cast<uint32_t>(B) * wpr;
  const long long src_wpr = f.src_stride / static_cast<long long>(sizeof(T));
  const T* src = static_cast<const T*>(f.src);
  T* d = reinterpret_cast<T*>(dst);
  for (uint32_t i = static_cast<uint32_t>(block) * kThreads + threadIdx.x; i < n;
       i += static_cast<uint32_t>(blocks) * kThreads) {
    const uint32_t row = wpr == 1 ? i : i / wpr;
    d[i] = src[row * src_wpr + (i - row * wpr)];
  }
}

// Tile `block` of a batch-minor [m, B] field of 4-byte elements, written
// batch-major: dst[b, j] = src[j, b].
__device__ __forceinline__ void add_transposed(const ReplayField& f, char* dst, int block, int B,
                                               uint32_t (&tile)[kTile][kTile + 1]) {
  const int m = static_cast<int>(f.row_bytes / 4);
  const int tiles_b = (B + kTile - 1) / kTile;
  const int b0 = (block % tiles_b) * kTile, j0 = (block / tiles_b) * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const uint32_t* s = static_cast<const uint32_t*>(f.src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int k = ty; k < kTile; k += kThreads / kTile) {
    const int j = j0 + k, b = b0 + tx;
    if (j < m && b < B) tile[k][tx] = s[static_cast<long long>(j) * B + b];
  }
  __syncthreads();
  for (int k = ty; k < kTile; k += kThreads / kTile) {
    const int b = b0 + k, j = j0 + tx;
    if (b < B && j < m) d[static_cast<long long>(b) * m + j] = tile[tx][k];
  }
}

__global__ void __launch_bounds__(kThreads) replay_add_kernel(const __grid_constant__ ReplayFields fields,
                                                              const __grid_constant__ AddPlan plan,
                                                              long long pos, int B) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  int k = 0;  // the block's field
  while (k + 1 < fields.n && static_cast<int>(blockIdx.x) >= plan.first[k + 1]) ++k;
  const ReplayField& f = fields.f[k];
  const int block = blockIdx.x - plan.first[k], blocks = plan.first[k + 1] - plan.first[k];
  char* dst = static_cast<char*>(f.store) + pos * f.row_bytes;
  if (f.transposed) add_transposed(f, dst, block, B, tile);
  else if (f.word == 16) add_words<uint4>(f, dst, block, blocks, B);
  else if (f.word == 4) add_words<uint32_t>(f, dst, block, blocks, B);
  else add_words<uint8_t>(f, dst, block, blocks, B);
}

// Sample s's entry: JAX's randint draw at counter s (the host splits the
// key), (start + off) mod capacity; off goes to offsets[s] unless null.
__device__ __forceinline__ long long draw_anchor(const SampleParams& p, long long s,
                                                 int32_t* offsets) {
  const uint32_t c = static_cast<uint32_t>(s);
  const uint32_t hi = tf::bits(p.hi_k0, p.hi_k1, 0u, c);
  const uint32_t lo = tf::bits(p.lo_k0, p.lo_k1, 0u, c);
  const uint32_t off = ((hi % p.span) * p.multiplier + lo % p.span) % p.span;  // wraps as uint32
  if (offsets != nullptr) offsets[s] = static_cast<int32_t>(off);
  return (p.start + off) % p.capacity;
}

// x mod d for 32-bit x and d >= 1 from magic = (2**64 - 1) / d + 1
// (Lemire, Kaser and Kurz, "Faster remainder by direct computation", 2019):
// a multiply and a high multiply in place of a division.
__device__ __forceinline__ uint32_t fast_mod(uint32_t x, unsigned long long magic, uint32_t d) {
  return static_cast<uint32_t>(__umul64hi(magic * x, d));
}

// A field as replay_sample reads it from its parameters (a compact
// ReplayField: 32 bytes, so that the launch carries fewer), in table order.
struct SampleField {
  const char* store;
  char* out[2];   // the entries, the successors
  int row_bytes;  // below 2**31 (the launcher checks)
  int word;
};

struct SampleFields {
  SampleField f[kMaxFields];
};

// Item i of a sample: its table position (the fields after the first that
// start at or before it), its row (0 the entry, 1 the successor) and word.
struct ItemAt {
  int q, h, w;
};

__device__ __forceinline__ ItemAt item_at(const SamplePlan& plan, int i) {
  int q = 0;
#pragma unroll
  for (int k = 1; k < kMaxFields; ++k) q += i >= plan.first[k] ? 1 : 0;
  const int w = i - plan.first[q];
  const int wpr = plan.wpr[q];
  const int h = w >= wpr ? 1 : 0;
  return {q, h, w - h * wpr};
}

// A group of plan.group lanes a unit (a chunk of a sample's items), no
// shared memory and no barrier: a lane reads its items' fields from the
// parameters (the constant cache) by their table position, the fields
// handed over in table order.  The group's first lane draws the sample's
// entry and successor (both threefry blocks, the remainders by
// multiplication) and hands them to the group by shuffle; each lane then
// loads its K words of the chunk
// (items lane, lane + group, ...), every load before any store, and stores
// them.  A small n takes K = kSlotsFew, so that each lane's chain of
// loads is short and more warps share the work; a large one kSlotsMany, one
// chunk (and one draw) a sample.
template <int K>
__global__ void __launch_bounds__(kMaxGroupThreads) replay_sample_kernel(
    const __grid_constant__ SampleFields fields, const __grid_constant__ SampleParams p,
    const __grid_constant__ SamplePlan plan, int32_t* __restrict__ offsets) {
  const int G = plan.group;
  const int lane = threadIdx.x & (G - 1);
  const long long s = static_cast<long long>(blockIdx.x) * plan.units_per_block + threadIdx.x / G;
  const int base = static_cast<int>(blockIdx.y) * plan.chunk_items;  // the unit's chunk
  const bool live = s < p.n;
  uint32_t row0 = 0u, row1 = 0u;  // the entry, its successor
  if (lane == 0 && live) {
    const uint32_t c = static_cast<uint32_t>(s);
    const uint32_t hi = tf::bits(p.hi_k0, p.hi_k1, 0u, c);
    const uint32_t lo = tf::bits(p.lo_k0, p.lo_k1, 0u, c);
    const unsigned long long m = plan.span_magic;
    const uint32_t off = fast_mod(fast_mod(hi, m, p.span) * p.multiplier + fast_mod(lo, m, p.span), m, p.span);
    if (offsets != nullptr && base == 0) offsets[s] = static_cast<int32_t>(off);
    // start, batch and capacity lie below 2**31 (the launcher checks), so
    // these sums fit 32 bits; where off < capacity and batch < capacity
    // (plan.wrap_once) each wraps at most once
    const uint32_t cap = static_cast<uint32_t>(p.capacity);
    row0 = static_cast<uint32_t>(p.start) + off;
    row0 = plan.wrap_once ? (row0 >= cap ? row0 - cap : row0) : row0 % cap;
    row1 = row0 + static_cast<uint32_t>(p.batch);
    row1 = plan.wrap_once ? (row1 >= cap ? row1 - cap : row1) : row1 % cap;
  }
  row0 = __shfl_sync(0xffffffffu, row0, 0, G);
  row1 = __shfl_sync(0xffffffffu, row1, 0, G);
  if (!live) return;  // after the shuffles
  uint4 v[K];
  char* dst[K];  // where each word goes, and its size (0: none)
  int size[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = base + lane + G * k;
    size[k] = 0;
    if (i < plan.items) {
      const ItemAt it = item_at(plan, i);
      const SampleField& f = fields.f[it.q];
      const char* src = f.store + static_cast<long long>(it.h ? row1 : row0) * f.row_bytes +
                        static_cast<long long>(it.w) * f.word;
      dst[k] = f.out[it.h] + s * f.row_bytes + static_cast<long long>(it.w) * f.word;
      size[k] = f.word;
      if (f.word == 16) v[k] = __ldg(reinterpret_cast<const uint4*>(src));
      else if (f.word == 4) v[k].x = __ldg(reinterpret_cast<const uint32_t*>(src));
      else v[k].x = __ldg(reinterpret_cast<const uint8_t*>(src));
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (size[k] == 16) *reinterpret_cast<uint4*>(dst[k]) = v[k];
    else if (size[k] == 4) *reinterpret_cast<uint32_t*>(dst[k]) = v[k].x;
    else if (size[k] == 1) *dst[k] = static_cast<char>(v[k].x);
  }
}

// ---------------------------------------------------------------------------
// replay_sample_stacked: a warp a sample
// ---------------------------------------------------------------------------

constexpr int kWarpsWords = 4;  // the words build: samples (warps) a block
constexpr int kMaxStage = 200 * 1024;  // the bulk build: shared memory for a sample's K + 1 frames

// Entry a - i * batch of the ring for -1 <= i < K (the caller checks
// capacity >= (K + 1) * batch, so one correction suffices).
__device__ __forceinline__ long long back(long long a, int i, const SampleParams& p) {
  long long e = a - i * p.batch;
  if (e < 0) e += p.capacity;
  if (e >= p.capacity) e -= p.capacity;
  return e;
}

// The staging map of one sample whose entry is a.  Entry i of the map is
// E_i = a - i * batch; the successor's anchor is E_{-1}.  The warp loads the
// K done flags f_i = done[E_i], i = 0 .. K - 1, a lane each, and a ballot
// gives both windows' lookback depths: the entry's window looks at f_1 ..
// f_{K-1} (depth mc, the flags before the first set one), the successor's
// at f_0 .. f_{K-2} (depth mn).  Slot 0 holds E_{-1}, slot 1 + i holds E_i
// for i <= max(mc, mn - 1): at most K + 1 distinct entries.  Frame j
// (newest first) of the entry's window is slot 1 + min(j, mc), of the
// successor's slot min(j, mn).
struct StageMap {
  long long a;   // the entry
  int mc, mn;    // lookback depths of the entry's and the successor's windows
  int slots;     // entries staged: 2 + max(mc, mn - 1)
};

__device__ __forceinline__ StageMap stage_map(const SampleParams& p, const StackParams& st,
                                              long long s, int32_t* offsets) {
  const int lane = threadIdx.x % 32;
  long long a = 0;
  if (lane == 0) a = draw_anchor(p, s, offsets);
  a = __shfl_sync(0xffffffffu, a, 0);
  const bool f = lane < st.k && st.done[back(a, lane, p)];
  const unsigned flags = __ballot_sync(0xffffffffu, f);
  const unsigned low = (1u << (st.k - 1)) - 1u;  // K - 1 flags
  const unsigned cur = (flags >> 1) & low, nxt = flags & low;
  StageMap m;
  m.a = a;
  m.mc = cur ? __ffs(cur) - 1 : st.k - 1;
  m.mn = nxt ? __ffs(nxt) - 1 : st.k - 1;
  m.slots = 2 + max(m.mc, m.mn - 1);
  return m;
}

// The other fields' entry and successor rows, a lane a word.
template <typename T>
__device__ __forceinline__ void copy_pair(const ReplayField& f, long long s, long long a,
                                          long long a_next) {
  const int lane = threadIdx.x % 32;
  const long long wpr = f.row_bytes / static_cast<long long>(sizeof(T));
  const T* store = static_cast<const T*>(f.store);
  T* cur = static_cast<T*>(f.out_cur) + s * wpr;
  T* nxt = static_cast<T*>(f.out_nxt) + s * wpr;
  for (long long w = lane; w < wpr; w += 32) {
    cur[w] = store[a * wpr + w];
    nxt[w] = store[a_next * wpr + w];
  }
}

__device__ __forceinline__ void copy_other_fields(const ReplayFields& fields, int obs_field,
                                                  long long s, long long a, long long a_next) {
  for (int j = 0; j < fields.n; ++j) {
    if (j == obs_field) continue;
    const ReplayField& f = fields.f[j];
    if (f.word == 16) copy_pair<uint4>(f, s, a, a_next);
    else if (f.word == 4) copy_pair<uint32_t>(f, s, a, a_next);
    else copy_pair<uint8_t>(f, s, a, a_next);
  }
}

// The bulk build (an obs row of a multiple of 16 bytes on 16-byte
// boundaries): one block, one warp, a sample.  Lane 0 stages the <= K + 1
// distinct frames with one cp.async.bulk each, completing on one mbarrier,
// then writes the 2K output frames from shared memory with bulk stores
// while the other lanes copy the other fields.
__global__ void __launch_bounds__(32) replay_sample_stacked_bulk_kernel(
    ReplayFields fields, SampleParams p, StackParams st, int32_t* __restrict__ offsets) {
  extern __shared__ __align__(16) uint8_t stage[];
  __shared__ uint64_t bar;
  const long long s = blockIdx.x;
  const int lane = threadIdx.x;
  if (lane == 0) bulk::barrier_init(&bar, 1);
  __syncwarp();
  const StageMap m = stage_map(p, st, s, offsets);
  const ReplayField& f = fields.f[st.obs_field];
  const uint32_t row = static_cast<uint32_t>(f.row_bytes);
  const uint8_t* store = static_cast<const uint8_t*>(f.store);
  if (lane == 0) {
    bulk::arrive_expect(&bar, m.slots * row);
    for (int i = 0; i < m.slots; ++i)
      bulk::load(stage + i * row, store + back(m.a, i - 1, p) * f.row_bytes, row, &bar);
  }
  const long long a_next = back(m.a, -1, p);
  copy_other_fields(fields, st.obs_field, s, m.a, a_next);
  bulk::wait(&bar, 0);
  if (lane == 0) {
    uint8_t* cur = static_cast<uint8_t*>(f.out_cur) + s * st.k * f.row_bytes;
    uint8_t* nxt = static_cast<uint8_t*>(f.out_nxt) + s * st.k * f.row_bytes;
    for (int j = 0; j < st.k; ++j) {  // frame j, newest first, at position K - 1 - j
      const long long at = static_cast<long long>(st.k - 1 - j) * f.row_bytes;
      bulk::store(cur + at, stage + (1 + min(j, m.mc)) * row, row);
      bulk::store(nxt + at, stage + min(j, m.mn) * row, row);
    }
    bulk::commit();
    bulk::wait_read();
  }
}

// The words build (any other obs row, e.g. the board DQN's 200-byte int8
// frames): a warp a sample, kWarpsWords samples a block; the warp copies the
// 2K output frames from the store in the obs field's words, four frames'
// loads in flight before their stores.
template <typename T>
__device__ __forceinline__ void copy_windows(const ReplayField& f, const StackParams& st,
                                             const SampleParams& p, const StageMap& m, long long s) {
  const int lane = threadIdx.x % 32;
  const long long wpr = f.row_bytes / static_cast<long long>(sizeof(T));
  const T* store = static_cast<const T*>(f.store);
  T* outs[2] = {static_cast<T*>(f.out_cur) + s * st.k * wpr, static_cast<T*>(f.out_nxt) + s * st.k * wpr};
  const int frames = 2 * st.k;  // frame q: window q / K's frame j = q % K, newest first
  for (int q0 = 0; q0 < frames; q0 += 4) {
    const T* src[4];
    T* dst[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = min(q0 + u, frames - 1), h = q >= st.k, j = q - h * st.k;
      const int slot = h ? min(j, m.mn) : 1 + min(j, m.mc);
      src[u] = store + back(m.a, slot - 1, p) * wpr;
      dst[u] = outs[h] + (st.k - 1 - j) * wpr;
    }
    for (long long w = lane; w < wpr; w += 32) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = src[u][w];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < frames) dst[u][w] = v[u];
    }
  }
}

__global__ void __launch_bounds__(32 * kWarpsWords) replay_sample_stacked_words_kernel(
    ReplayFields fields, SampleParams p, StackParams st, int32_t* __restrict__ offsets) {
  const long long s = static_cast<long long>(blockIdx.x) * kWarpsWords + threadIdx.x / 32;
  if (s >= p.n) return;  // a whole warp: the shuffles below see every lane
  const StageMap m = stage_map(p, st, s, offsets);
  const ReplayField& f = fields.f[st.obs_field];
  if (f.word == 16) copy_windows<uint4>(f, st, p, m, s);
  else if (f.word == 4) copy_windows<uint32_t>(f, st, p, m, s);
  else copy_windows<uint8_t>(f, st, p, m, s);
  copy_other_fields(fields, st.obs_field, s, m.a, back(m.a, -1, p));
}

}  // namespace

// One env batch of B entries into every field at entry pos.
extern "C" int replay_add_launch(const ReplayFields* fields, long long pos, int B, void* stream) {
  AddPlan plan;
  long long blocks = 0;
  for (int j = 0; j < fields->n; ++j) {
    const ReplayField& f = fields->f[j];
    plan.first[j] = static_cast<int>(blocks);
    if (f.transposed) {
      blocks += static_cast<long long>((B + kTile - 1) / kTile) * ((f.row_bytes / 4 + kTile - 1) / kTile);
    } else {
      const long long runs = (B * (f.row_bytes / f.word) + kThreads - 1) / kThreads;
      blocks += runs < kAddMaxRuns ? runs : kAddMaxRuns;
    }
  }
  plan.first[fields->n] = static_cast<int>(blocks);
  if (blocks < 1 || blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  replay_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *fields, plan, pos, B);
  return static_cast<int>(cudaGetLastError());
}

// The card's streaming multiprocessors (1 where it cannot be read).
static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
      sms = 1;
  }
  return sms;
}

// replay_sample's plan for n samples (with successors when batch > 0): the
// item map (fields by word size, widest first), the lanes a unit (the
// fewest of 8, 16 and 32 whose kSlotsMany words a lane cover a sample,
// widened to a warp while n samples' warps give the SMs at most
// kWarpsPerSM each: a small n is a chain of latencies that more lanes
// shorten, a large one a stream in which narrow groups share a warp), the
// words a lane (kSlotsFew while the units' warps still fit kWarpsPerSM an
// SM, else kSlotsMany) and the units a block: as many as give every SM a
// block, up to kMaxGroupThreads threads, in whole warps (the shuffles name
// every lane of a warp).  ordered gets the fields in table order, as the
// kernel reads them.
static SamplePlan sample_plan(const ReplayFields& fields, const SampleParams& p, SampleFields& ordered) {
  const int halves = p.batch > 0 ? 2 : 1;
  SamplePlan plan{};
  int at = 0, items = 0;
  for (int word : {16, 4, 1}) {
    for (int j = 0; j < fields.n; ++j) {
      const ReplayField& f = fields.f[j];
      if (f.word != word) continue;
      ordered.f[at] = {static_cast<const char*>(f.store),
                       {static_cast<char*>(f.out_cur), static_cast<char*>(f.out_nxt)},
                       static_cast<int>(f.row_bytes), f.word};
      plan.first[at] = items;
      plan.wpr[at] = static_cast<int>(fields.f[j].row_bytes / word);
      items += halves * plan.wpr[at++];
    }
  }
  for (int q = at; q <= kMaxFields; ++q) plan.first[q] = items;
  plan.items = items;
  const long long room = 32ll * kWarpsPerSM * sm_count();  // lanes the card keeps busy
  int g = 8;
  while (g < 32 && items > g * kSlotsMany) g *= 2;
  while (g < 32 && static_cast<long long>(p.n) * 2 * g <= room) g *= 2;
  plan.group = g;
  const int few = (items + g * kSlotsFew - 1) / (g * kSlotsFew);  // chunks a sample of kSlotsFew words a lane
  plan.slots = static_cast<long long>(p.n) * few * g <= room ? kSlotsFew : kSlotsMany;
  plan.chunk_items = g * plan.slots;
  plan.chunks = std::max(1, (items + plan.chunk_items - 1) / plan.chunk_items);
  plan.wrap_once = p.span <= p.capacity && p.batch < p.capacity;
  plan.span_magic = ~0ull / (p.span > 0 ? p.span : 1) + 1;
  const int sms = sm_count();
  const int warp = 32 / g;  // units a warp
  const long long units = static_cast<long long>(p.n) * plan.chunks;  // spread over every SM
  const long long want = ((units + sms - 1) / sms + warp - 1) / warp * warp;
  plan.units_per_block = static_cast<int>(std::min<long long>(kMaxGroupThreads / g, std::max<long long>(warp, want)));
  return plan;
}

// n samples of every field (and their successors when batch > 0); offsets:
// int32[n] (the randint draws) or null.  start and batch lie in [0, 2**31),
// the capacity and every row's bytes below 2**31, every field's word is 16,
// 4 or 1 bytes.
extern "C" int replay_sample_launch(const ReplayFields* fields, const SampleParams* params,
                                    void* offsets, void* stream) {
  const SampleParams& p = *params;
  if (p.start < 0 || p.start >= (1ll << 31) || p.batch < 0 || p.batch >= (1ll << 31) ||
      p.capacity < 1 || p.capacity >= (1ll << 31) || p.n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < fields->n; ++j)
    if ((fields->f[j].word != 16 && fields->f[j].word != 4 && fields->f[j].word != 1) ||
        fields->f[j].row_bytes >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
  SampleFields ordered{};
  const SamplePlan plan = sample_plan(*fields, p, ordered);
  const dim3 grid(static_cast<unsigned>((p.n + plan.units_per_block - 1) / plan.units_per_block),
                  static_cast<unsigned>(plan.chunks));
  if (plan.chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = plan.units_per_block * plan.group;
  const auto st = static_cast<cudaStream_t>(stream);
  int32_t* off = static_cast<int32_t*>(offsets);
  if (plan.slots == kSlotsFew)
    replay_sample_kernel<kSlotsFew><<<grid, threads, 0, st>>>(ordered, p, plan, off);
  else
    replay_sample_kernel<kSlotsMany><<<grid, threads, 0, st>>>(ordered, p, plan, off);
  return static_cast<int>(cudaGetLastError());
}

// replay_sample's shape for n samples of these fields: out = [lanes a
// unit, words a lane, units (chunks) a sample, units a block, a sample's
// words].
extern "C" int replay_sample_shape(const ReplayFields* fields, long long batch, int n, int* out) {
  SampleParams p{};
  p.batch = batch;
  p.n = n;
  SampleFields ordered{};
  const SamplePlan plan = sample_plan(*fields, p, ordered);
  out[0] = plan.group;
  out[1] = plan.slots;
  out[2] = plan.chunks;
  out[3] = plan.units_per_block;
  out[4] = plan.items;
  return 0;
}

// n samples of every field and their successors, the obs_field gathered as
// K-frame windows; offsets: int32[n] (the randint draws) or null.
// stack->bulk picks the bulk build (kernels.py:replay_stacked_build).
extern "C" int replay_sample_stacked_launch(const ReplayFields* fields,
                                            const SampleParams* params,
                                            const StackParams* stack, void* offsets,
                                            void* stream) {
  if (stack->k < 1 || stack->k > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stack->bulk) {
    const long long smem = (stack->k + 1) * fields->f[stack->obs_field].row_bytes;
    if (smem > kMaxStage) return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t opted = cudaFuncSetAttribute(
        replay_sample_stacked_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStage);
    if (opted != cudaSuccess) return static_cast<int>(opted);
    replay_sample_stacked_bulk_kernel<<<params->n, 32, static_cast<size_t>(smem), s>>>(
        *fields, *params, *stack, static_cast<int32_t*>(offsets));
  } else {
    const int blocks = (params->n + kWarpsWords - 1) / kWarpsWords;
    replay_sample_stacked_words_kernel<<<blocks, 32 * kWarpsWords, 0, s>>>(
        *fields, *params, *stack, static_cast<int32_t*>(offsets));
  }
  return static_cast<int>(cudaGetLastError());
}
