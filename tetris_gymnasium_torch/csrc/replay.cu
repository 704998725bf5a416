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
// (a multiple of the batch, so the block is contiguous).  blockIdx.y picks
// the field; the threads copy 16-, 4- or 1-byte words, whichever the field's
// entry size, alignment and source row stride allow.  A source row may lie
// at any stride (the newest frame of the DQN's [B, K, H, W] window is a
// strided [B, H, W] view), so no contiguous copy is made first.  A field may
// also come batch-minor, [n, B] of 4-byte elements seen as [B, n] (the
// engine's [A, B] mask): the kernel transposes it as it writes.
//
// replay_sample: one launch draws JAX's randint(key, (n,), 0, span) on the
// card (threefry.cuh; the host splits the key and passes span and the
// multiplier, 2**16 % span squared in uint32, mod span), forms idx = (start + off) mod
// capacity and, for sample_with_next, nxt = (idx + batch) mod capacity, and
// gathers the entry (and its successor) of every field.  No index crosses
// from the host, and one launch replaces a gather per field.
//
// replay_sample_stacked: replay_sample with successors whose observation
// field comes back as K-frame windows [n, K, ...], rebuilt from the single
// frames the buffer stores (the same env's previous frame is batch entries
// earlier).  The host folds the (K - 1) * batch entries that sampling skips
// into start.  For an anchor a (the entry and its successor), the thread of
// that anchor reads the done flags of transitions a - j * batch, j = 1 ..
// K - 1; the lookback depth m is the number of them before the first set
// flag; frame j (newest first) is entry (a - min(j, m) * batch) mod
// capacity, written oldest first.  So a window never crosses into a previous
// episode: its deeper frames repeat the episode's first one.
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

#include <cstdint>
#include <cuda_runtime.h>

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
};

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerBlock = 4;
constexpr int kMaxStack = 16;

template <typename T>
__device__ __forceinline__ void copy_words(char* dst, const char* src, long long n_words,
                                           long long wpr, long long src_wpr, long long i,
                                           long long stride) {
  // word i of the block is word i % wpr of row i / wpr; the source rows lie
  // src_wpr words apart
  for (; i < n_words; i += stride)
    reinterpret_cast<T*>(dst)[i] =
        reinterpret_cast<const T*>(src)[(i / wpr) * src_wpr + i % wpr];
}

__global__ void __launch_bounds__(kThreads) replay_add_kernel(ReplayFields fields, long long pos,
                                                              int B) {
  const ReplayField& f = fields.f[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  char* dst = static_cast<char*>(f.store) + pos * f.row_bytes;
  const char* src = static_cast<const char*>(f.src);
  if (f.transposed) {
    // dst[b, j] = src[j, b], 4-byte elements; i runs over the destination
    const long long m = f.row_bytes / 4;
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (long long i = i0; i < B * m; i += stride) d[i] = s[(i % m) * B + i / m];
    return;
  }
  const long long n_words = B * f.row_bytes / f.word;
  const long long wpr = f.row_bytes / f.word, src_wpr = f.src_stride / f.word;
  if (f.word == 16) copy_words<uint4>(dst, src, n_words, wpr, src_wpr, i0, stride);
  else if (f.word == 4) copy_words<uint32_t>(dst, src, n_words, wpr, src_wpr, i0, stride);
  else copy_words<uint8_t>(dst, src, n_words, wpr, src_wpr, i0, stride);
}

template <typename T>
__device__ __forceinline__ void gather_rows(const ReplayField& f, const long long* rows,
                                            long long first, int n_rows, int per, int n) {
  // rows[(h * kSamplesPerBlock + s) * per + p] is row p of sample first + s
  // in out_cur (h = 0) or out_nxt (h = 1); a sample has per rows
  const long long wpr = f.row_bytes / static_cast<long long>(sizeof(T));
  const T* store = static_cast<const T*>(f.store);
  for (long long i = threadIdx.x; i < n_rows * wpr; i += blockDim.x) {
    const int r = static_cast<int>(i / wpr);
    const long long w = i % wpr;
    const int s = (r / per) % kSamplesPerBlock;
    if (first + s >= n) continue;
    T* out = static_cast<T*>(r < kSamplesPerBlock * per ? f.out_cur : f.out_nxt);
    out[((first + s) * per + r % per) * wpr + w] = store[rows[r] * wpr + w];
  }
}

__device__ __forceinline__ void gather_field(const ReplayField& f, const long long* rows,
                                             long long first, int n_rows, int per, int n) {
  if (f.word == 16) gather_rows<uint4>(f, rows, first, n_rows, per, n);
  else if (f.word == 4) gather_rows<uint32_t>(f, rows, first, n_rows, per, n);
  else gather_rows<uint8_t>(f, rows, first, n_rows, per, n);
}

// rows[s] = idx and rows[kSamplesPerBlock + s] = its successor for the
// block's samples (threads 0 .. kSamplesPerBlock - 1).
__device__ __forceinline__ void draw_rows(const SampleParams& p, long long first,
                                          int32_t* offsets, long long* rows) {
  if (threadIdx.x < kSamplesPerBlock) {
    const long long s = first + threadIdx.x;
    long long idx = 0;
    if (s < p.n) {
      const uint32_t c = static_cast<uint32_t>(s);
      const uint32_t hi = tf::bits(p.hi_k0, p.hi_k1, 0u, c);
      const uint32_t lo = tf::bits(p.lo_k0, p.lo_k1, 0u, c);
      const uint32_t off = ((hi % p.span) * p.multiplier + lo % p.span) % p.span;  // wraps as uint32
      if (offsets != nullptr) offsets[s] = static_cast<int32_t>(off);
      idx = (p.start + off) % p.capacity;
    }
    rows[threadIdx.x] = idx;
    rows[kSamplesPerBlock + threadIdx.x] = (idx + p.batch) % p.capacity;
  }
}

__global__ void __launch_bounds__(kThreads) replay_sample_kernel(ReplayFields fields,
                                                                 SampleParams p,
                                                                 int32_t* __restrict__ offsets) {
  __shared__ long long rows[2 * kSamplesPerBlock];
  const long long first = static_cast<long long>(blockIdx.x) * kSamplesPerBlock;
  draw_rows(p, first, offsets, rows);
  __syncthreads();
  const int n_rows = p.batch > 0 ? 2 * kSamplesPerBlock : kSamplesPerBlock;
  for (int j = 0; j < fields.n; ++j) gather_field(fields.f[j], rows, first, n_rows, 1, p.n);
}

__global__ void __launch_bounds__(kThreads) replay_sample_stacked_kernel(
    ReplayFields fields, SampleParams p, StackParams st, int32_t* __restrict__ offsets) {
  __shared__ long long rows[2 * kSamplesPerBlock];
  __shared__ long long frames[2 * kSamplesPerBlock * kMaxStack];
  const long long first = static_cast<long long>(blockIdx.x) * kSamplesPerBlock;
  draw_rows(p, first, offsets, rows);
  __syncthreads();
  if (threadIdx.x < 2 * kSamplesPerBlock) {
    // one thread per anchor: the sample's entry or its successor
    const long long anchor = rows[threadIdx.x];
    int m = st.k - 1;
    for (int j = 1; j < st.k; ++j) {
      long long d = (anchor - j * p.batch) % p.capacity;
      d += d < 0 ? p.capacity : 0;
      if (st.done[d]) {
        m = j - 1;
        break;
      }
    }
    long long* out = frames + threadIdx.x * st.k;
    for (int j = 0; j < st.k; ++j) {
      long long e = (anchor - (j < m ? j : m) * p.batch) % p.capacity;
      e += e < 0 ? p.capacity : 0;
      out[st.k - 1 - j] = e;  // newest first -> oldest first
    }
  }
  __syncthreads();
  for (int j = 0; j < fields.n; ++j) {
    if (j == st.obs_field)
      gather_field(fields.f[j], frames, first, 2 * kSamplesPerBlock * st.k, st.k, p.n);
    else
      gather_field(fields.f[j], rows, first, 2 * kSamplesPerBlock, 1, p.n);
  }
}

}  // namespace

// One env batch of B entries into every field at entry pos.
extern "C" int replay_add_launch(const ReplayFields* fields, long long pos, int B, void* stream) {
  long long most = 0;
  for (int j = 0; j < fields->n; ++j) {
    const ReplayField& f = fields->f[j];
    const long long words = f.transposed ? B * f.row_bytes / 4 : B * f.row_bytes / f.word;
    most = words > most ? words : most;
  }
  long long blocks = (most + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(fields->n));
  replay_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*fields, pos, B);
  return static_cast<int>(cudaGetLastError());
}

// n samples of every field (and their successors when batch > 0); offsets:
// int32[n] (the randint draws) or null.
extern "C" int replay_sample_launch(const ReplayFields* fields, const SampleParams* params,
                                    void* offsets, void* stream) {
  const int blocks = (params->n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  replay_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *fields, *params, static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// n samples of every field and their successors, the obs_field gathered as
// K-frame windows; offsets: int32[n] (the randint draws) or null.
extern "C" int replay_sample_stacked_launch(const ReplayFields* fields,
                                            const SampleParams* params,
                                            const StackParams* stack, void* offsets,
                                            void* stream) {
  if (stack->k < 1 || stack->k > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (params->n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  replay_sample_stacked_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *fields, *params, *stack, static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
