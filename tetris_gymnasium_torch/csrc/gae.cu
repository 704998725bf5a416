// Generalised advantage estimation for Hopper (sm_90a): a block a slab of
// 32 envs over all T steps, the slab brought into shared memory by
// asynchronous copies ahead of the recursion, a thread an env.
//
// Replaces tetris_gymnasium_tpu/rl/ppo.py:_gae (:147), a reverse lax.scan
// over the rollout's T steps.  Each env's recursion is sequential in t and
// independent of every other env, so a thread walks its env from t = T-1
// down to 0 and keeps gae and next_value in registers: one launch per train
// step, where a scan of small kernels would take T.  The plain PyTorch twin
// is tetris_gymnasium_torch/rl/ppo.py:gae_plain; the output is bit-equal to
// it.
//
// Arithmetic, in JAX's order, each operation rounded on its own (the
// _rn intrinsics are never contracted into an FMA):
//   not_done = 1 - done
//   delta    = (reward + (gamma * next_value) * not_done) - value
//   gae      = delta + (gamma_lambda * not_done) * gae
//   target   = gae + value
// gamma_lambda is the float32 rounding of the double product gamma * lambda,
// as Python forms ppo.gamma * ppo.gae_lambda before JAX sees it.  A
// parallel scan over T (composing the maps gae -> delta + c * gae) would
// round in another order and lose bit-equality with JAX's sequential scan.
//
// Layout: every [T, B] array has the env batch B as its minor axis, so a
// slab's row t is 32 consecutive words (reward, value, advantage, target)
// or bytes (done).
//
// Bound on this card: bytes.  Per (t, env) it reads reward, value (4 bytes
// each) and done (1 byte) and writes advantage and target (4 bytes each),
// 17 bytes, plus 4 bytes of last_value per env: 17.8 MB at T = 128, B =
// 8192 (5.33 us at 3.35 TB/s), 142.6 MB at B = 65536 (42.6 us).
//
// What held the first design back (a thread an env in 64-thread blocks,
// loads of 8 steps in flight, PERF.md): at B = 8192 it ran two
// warps an SM with about 4.6 KB in flight, where ~18 KB an SM covers the
// ~0.7 us of HBM latency at 3.35 TB/s, so the 128-step recursion waited on
// some 16 DRAM round trips (0.0190 ms, 28% of its bound; 59% at 65536,
// where eight times as many warps hide the latency).  Here each block is
// two warps: warp 1 brings the slab in, chunks of 16 steps in reverse t
// order, into a ring of 8 stages in shared memory, each completed on an
// mbarrier (at T = 128 the whole slab, 36.9 KB, is in flight at once;
// longer rollouts wait for a stage to be released); warp 0 runs the
// recursion, a lane an env, reading row t of a stage (32 consecutive words:
// no bank conflict), as soon as each chunk lands.  Chunk k holds steps
// T - 16 (k + 1) .. T - 16 k - 1; where 16 does not divide T the earliest
// chunk is short, and its stage starts at step 0 all the same.  Two
// builds, picked by the wrapper from the shape (kernels.py:gae_build):
//   tma (kTma): where every row of every array lies on 16 bytes (B % 16 ==
//     0 and 16-byte aligned tensors), one TMA tensor copy (a 32-env x
//     16-step box of a CUtensorMap, encoded on the host through
//     cudaGetDriverEntryPoint, so nothing links -lcuda) an array a chunk,
//     global -> shared; TMA fills with zeros what lies past the last env
//     or the last step, and leaves it out of a store.  The recursion stages
//     advantage and target a whole chunk at a time in shared memory (4
//     stages; the short chunk's outputs go straight out) and stores them
//     with one tensor copy each, shared -> global, after
//     fence.proxy.async, waiting with cp.async.bulk.wait_group before it
//     reuses a stage and before it exits.  A first version copied each row
//     with a 1-D cp.async.bulk (80 copies a chunk): 0.0165 ms at every B
//     up to 8192, the copies' issue the block's critical path; with tensor
//     copies 0.00689 ms at 8192 and 0.0552 at 65536 (77% of the bound at
//     both) on inputs the last launch left in the L2, and 0.0121 and
//     0.0602 (44% and 71%) on inputs read from HBM, as the path gives
//     them: cold, the stream from HBM adds to the block's fixed time
//     rather than hiding under it (PERF.md, an H100 at 700 W).  A box that
//     starts before step 0 (the short chunk placed at its end) stopped the
//     card with an illegal instruction, so no box starts before the tensor.
//   cp.async (ragged B, B = 1 or 1001): rows of other lengths or
//     alignments are not tensor copies, so reward and value come in with a
//     4-byte cp.async a word, completed on the same ring's mbarriers
//     (cp.async.mbarrier.arrive), and done with ordinary byte loads
//     (cp.async moves 4, 8 or 16 aligned bytes), a chunk at a time (four
//     chunks' bytes in flight at once took longer: 0.0124 against 0.0100 ms
//     at B = 8192, 86 registers against 40); the recursion stores its
//     outputs directly, 32 consecutive words a row.
// Registers a thread (-Xptxas -v, CUDA 12.9): the tma build 31, the
// cp.async build 40, no spill.  Shared memory a block: the ring 8 x 4608
// bytes, the tma build's staging 4 x 4096 more (53,376 in all, four blocks
// an SM), the cp.async build's 41,088 (five).

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its encoder's types only: the encoder comes from the runtime
#include <cuda_runtime.h>

namespace {

constexpr int kEnvs = 32;      // envs a block: a lane of warp 0 each
constexpr int kRows = 16;      // steps a chunk
constexpr int kStages = 8;     // chunks in flight: all of T = 128
constexpr int kOutStages = 4;  // tma build: chunks of outputs being stored
constexpr int kThreads = 64;   // warp 0 the recursion, warp 1 the loads

struct Stage {  // one chunk's rows of the slab, in t order
  float reward[kRows][kEnvs];
  float value[kRows][kEnvs];
  uint8_t done[kRows][kEnvs];
};

struct OutStage {
  float advantage[kRows][kEnvs];
  float target[kRows][kEnvs];
};

template <bool kTma>
struct Smem {
  Stage in[kStages];
  OutStage out[kTma ? kOutStages : 1];
  uint64_t full[kStages];   // a chunk has landed
  uint64_t empty[kStages];  // the recursion is done with a stage
};

// The tensor maps of the tma build: reward, value, done, advantage, target.
struct Maps {
  CUtensorMap reward, value, done, advantage, target;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ready = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ready);
}

// The box of `map` at (env x, step y), global -> shared, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y),
        "r"(smem_addr(bar))
      : "memory");
}

// shared -> the box of `map` at (x, y), in this thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, int x, int y, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
               :
               : "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(smem_addr(src))
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's latest bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's writes to shared memory before the async proxy's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :
               : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

// An arrival on `bar` when this thread's cp.asyncs so far have landed (the
// pending count is raised by one first, so the net count is unchanged).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Chunk k: its n steps from y0, stage rows 0 .. n - 1.  The earliest chunk
// is short where kRows does not divide T; its stage starts at step 0 all the
// same, so that no copy starts before the tensor.
__device__ __forceinline__ void chunk_rows(int k, int T, int& y0, int& n) {
  y0 = max(T - kRows * (k + 1), 0);
  n = min(kRows, T - kRows * k);
}

// One step of the recursion for stage row r: returns the target.
__device__ __forceinline__ float gae_row(const Stage& st, int r, int lane, float gamma,
                                         float gamma_lambda, float& gae, float& next_value) {
  const float rw = st.reward[r][lane];
  const float v = st.value[r][lane];
  const float not_done = st.done[r][lane] ? 0.0f : 1.0f;
  const float delta =
      __fsub_rn(__fadd_rn(rw, __fmul_rn(__fmul_rn(gamma, next_value), not_done)), v);
  gae = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lambda, not_done), gae));
  next_value = v;
  return __fadd_rn(gae, v);
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads) gae_kernel(
    const float* __restrict__ reward, const float* __restrict__ value,
    const uint8_t* __restrict__ done, const float* __restrict__ last_value,
    float* __restrict__ advantage, float* __restrict__ target, int T, int B, float gamma,
    float gamma_lambda, const __grid_constant__ Maps maps) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem<kTma>& sm = *reinterpret_cast<Smem<kTma>*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int e0 = blockIdx.x * kEnvs;
  const int n_env = min(kEnvs, B - e0);
  const int n_chunks = (T + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], kTma ? 1 : 32);  // cp.async: each lane of warp 1 arrives
      mbar_init(&sm.empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // warp 1: the loads
    if constexpr (kTma) {
      if (lane == 0) {
        for (int k = 0; k < n_chunks; ++k) {
          const int s = k % kStages;
          if (k >= kStages) mbar_wait(&sm.empty[s], ((k / kStages) - 1) & 1);
          int y0, n;
          chunk_rows(k, T, y0, n);
          Stage& st = sm.in[s];
          mbar_arrive_expect_tx(&sm.full[s], sizeof(Stage));  // whole boxes, zeros included
          tma_load(st.reward, maps.reward, e0, y0, &sm.full[s]);
          tma_load(st.value, maps.value, e0, y0, &sm.full[s]);
          tma_load(st.done, maps.done, e0, y0, &sm.full[s]);
        }
      }
    } else {
      const bool valid = lane < n_env;
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&sm.empty[s], ((k / kStages) - 1) & 1);
        int y0, n;
        chunk_rows(k, T, y0, n);
        Stage& st = sm.in[s];
        uint8_t d[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool in = valid && r < n;
          const long long i = static_cast<long long>(y0 + r) * B + e0 + lane;
          if (in) {
            cp_async4(&st.reward[r][lane], reward + i);
            cp_async4(&st.value[r][lane], value + i);
          }
          d[r] = in ? done[i] : 0;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) st.done[r][lane] = d[r];
        cp_async_arrive(&sm.full[s]);
        mbar_arrive(&sm.full[s]);  // releases the done bytes
      }
    }
    return;
  }

  // warp 0: the recursion, lane `lane` env e0 + lane
  const bool valid = lane < n_env;
  const int b = e0 + lane;
  float gae = 0.0f;
  float next_value = valid ? last_value[b] : 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kStages;
    int y0, n;
    chunk_rows(k, T, y0, n);
    mbar_wait(&sm.full[s], (k / kStages) & 1);
    const Stage& st = sm.in[s];
    OutStage& o = sm.out[kTma ? k % kOutStages : 0];
    if constexpr (kTma) {
      // the store of chunk k - kOutStages has read its stage
      if (k >= kOutStages && lane == 0) bulk_wait_read<kOutStages - 1>();
      __syncwarp();
    }
    if (n == kRows) {  // a whole chunk: every shared load can be issued ahead
#pragma unroll
      for (int r = kRows - 1; r >= 0; --r) {
        const float tg = gae_row(st, r, lane, gamma, gamma_lambda, gae, next_value);
        if constexpr (kTma) {
          o.advantage[r][lane] = gae;
          o.target[r][lane] = tg;
        } else if (valid) {
          const long long i = static_cast<long long>(y0 + r) * B + b;
          advantage[i] = gae;
          target[i] = tg;
        }
      }
    } else {  // the earliest, short chunk: its outputs go straight out
      for (int r = n - 1; r >= 0; --r) {
        const float tg = gae_row(st, r, lane, gamma, gamma_lambda, gae, next_value);
        if (valid) {
          const long long i = static_cast<long long>(y0 + r) * B + b;
          advantage[i] = gae;
          target[i] = tg;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // the stage may be refilled
    if (kTma && n == kRows) {
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        tma_store(maps.advantage, e0, y0, o.advantage);
        tma_store(maps.target, e0, y0, o.target);
        bulk_commit();
      }
    }
  }
  if constexpr (kTma) {
    if (lane == 0) bulk_wait_all();
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime, so that nothing
// links libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [T, B] array of `elem`-byte elements, boxes of kEnvs x kRows.
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int T, int B) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(B) * elem};
  const cuuint32_t box[2] = {kEnvs, kRows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTma>
int launch(const void* reward, const void* value, const void* done, const void* last_value,
           void* advantage, void* target, int T, int B, float gamma, float gamma_lambda,
           cudaStream_t stream) {
  Maps maps{};
  if constexpr (kTma) {
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!encode(&maps.reward, reward, f32, 4, T, B) || !encode(&maps.value, value, f32, 4, T, B) ||
        !encode(&maps.done, done, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, T, B) ||
        !encode(&maps.advantage, advantage, f32, 4, T, B) ||
        !encode(&maps.target, target, f32, 4, T, B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = static_cast<int>(sizeof(Smem<kTma>));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gae_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + kEnvs - 1) / kEnvs;
  gae_kernel<kTma><<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(reward), static_cast<const float*>(value),
      static_cast<const uint8_t*>(done), static_cast<const float*>(last_value),
      static_cast<float*>(advantage), static_cast<float*>(target), T, B, gamma, gamma_lambda,
      maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// reward, value: float32[T, B]; done: bool[T, B] (one byte, 0 or 1);
// last_value: float32[B]; advantage, target: float32[T, B] outputs.  tma:
// 1 for the tensor-copy build (every row of every array on 16 bytes: B % 16
// == 0 and 16-byte aligned tensors), 0 for the cp.async build (any shape).
extern "C" int gae_launch(const void* reward, const void* value, const void* done,
                          const void* last_value, void* advantage, void* target, int T, int B,
                          float gamma, float gamma_lambda, int tma, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return tma ? launch<true>(reward, value, done, last_value, advantage, target, T, B, gamma,
                            gamma_lambda, s)
             : launch<false>(reward, value, done, last_value, advantage, target, T, B, gamma,
                             gamma_lambda, s);
}
