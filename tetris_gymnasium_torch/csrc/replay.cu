// The device replay buffer's block write and its sample for Hopper (sm_90a).
//
// Replaces tetris_gymnasium_tpu/rl/buffers.py:add (:46), sample (:64) and
// sample_with_next (:70).  The buffer is a struct of arrays, one
// [capacity, ...] store per field (obs, mask, action, reward, done for the
// grouped DQN); the plain PyTorch twins are tetris_gymnasium_torch/rl/
// buffers.py:add_plain, sample_plain and sample_with_next_plain, and every
// output is bit-equal to them.
//
// replay_add: one launch writes one env batch into every field at entry pos
// (a multiple of the batch, so the block is contiguous).  blockIdx.y picks
// the field; the threads copy 16-, 4- or 1-byte words, whichever the field's
// entry size and alignment allow.  A field may come batch-minor, [n, B] of
// 4-byte elements seen as [B, n] (the engine's [A, B] mask): the kernel
// transposes it as it writes, so no transposed copy is made first.
//
// replay_sample: one launch draws JAX's randint(key, (n,), 0, span) on the
// card (threefry.cuh; the host splits the key and passes span and the
// multiplier, 2**16 % span squared in uint32, mod span), forms idx = (start + off) mod
// capacity and, for sample_with_next, nxt = (idx + batch) mod capacity, and
// gathers the entry (and its successor) of every field.  No index crosses
// from the host, and one launch replaces a gather per field.
//
// Bound on this card: bytes, and at the grouped DQN's shapes launch latency.
// add moves B entries in and out (2 * 2,249 bytes an env for the grouped
// features: obs 40 * 13 * 4, mask 40 * 4, action 4, reward 4, done 1);
// sample moves 2 * n entries out and reads as many.

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

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerBlock = 4;

template <typename T>
__device__ __forceinline__ void copy_words(char* dst, const char* src, long long n_words,
                                           long long i, long long stride) {
  for (; i < n_words; i += stride)
    reinterpret_cast<T*>(dst)[i] = reinterpret_cast<const T*>(src)[i];
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
  if (f.word == 16) copy_words<uint4>(dst, src, n_words, i0, stride);
  else if (f.word == 4) copy_words<uint32_t>(dst, src, n_words, i0, stride);
  else copy_words<uint8_t>(dst, src, n_words, i0, stride);
}

template <typename T>
__device__ __forceinline__ void gather_rows(const ReplayField& f, const long long* rows,
                                            long long first, int n_rows, int n) {
  // rows[r] for r < kSamplesPerBlock are entries of out_cur, the rest of out_nxt
  const long long wpr = f.row_bytes / static_cast<long long>(sizeof(T));
  const T* store = static_cast<const T*>(f.store);
  for (long long i = threadIdx.x; i < n_rows * wpr; i += blockDim.x) {
    const int r = static_cast<int>(i / wpr);
    const long long w = i % wpr;
    const int s = r % kSamplesPerBlock;
    if (first + s >= n) continue;
    T* out = static_cast<T*>(r < kSamplesPerBlock ? f.out_cur : f.out_nxt);
    out[(first + s) * wpr + w] = store[rows[r] * wpr + w];
  }
}

__global__ void __launch_bounds__(kThreads) replay_sample_kernel(ReplayFields fields,
                                                                 SampleParams p,
                                                                 int32_t* __restrict__ offsets) {
  __shared__ long long rows[2 * kSamplesPerBlock];
  const long long first = static_cast<long long>(blockIdx.x) * kSamplesPerBlock;
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
  __syncthreads();
  const int n_rows = p.batch > 0 ? 2 * kSamplesPerBlock : kSamplesPerBlock;
  for (int j = 0; j < fields.n; ++j) {
    const ReplayField& f = fields.f[j];
    if (f.word == 16) gather_rows<uint4>(f, rows, first, n_rows, p.n);
    else if (f.word == 4) gather_rows<uint32_t>(f, rows, first, n_rows, p.n);
    else gather_rows<uint8_t>(f, rows, first, n_rows, p.n);
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
