// The DQN's epsilon-greedy over a Q-net's action values for Hopper (sm_90a):
// one thread an env, its row's loads all in flight before any other work,
// randint's split of the action key made on the card.
//
// Replaces tetris_gymnasium_tpu/rl/dqn.py:train_step (:143-147):
//   greedy   = argmax(q)
//   random_a = jax.random.randint(act_key, (B,), 0, A)
//   explore  = jax.random.uniform(eps_key, (B,)) < epsilon
//   action   = where(explore, random_a, greedy)
// and, without keys, rl/evaluate.py:greedy_q (:124), the argmax alone.  XLA
// runs the argmax, the two draws and the select as separate passes; here one
// pass reads the A values of an env and writes its int32 action.  The plain
// PyTorch twin is tetris_gymnasium_torch/rl/dqn.py:act_plain; the actions
// are equal.
//
// The random bits are JAX's (threefry.cuh).  randint splits act_key in two
// (split(act_key) is the blocks of act_key at counters (0, 0) and (0, 1),
// the same in every lane, so each lane makes them itself and the host makes
// no draw), draws 32 bits hi and lo of each half at counter env_offset + b
// (the global env index; env_offset is a rank's first env, 0 on one
// device), and returns ((hi % A) * m + lo % A) % A in wrapping uint32
// arithmetic, m = (2**16 % A)**2 % A.  For A = 8 m is 0, so that build
// never makes the high half's key and draw.  The exploration draw is JAX's
// uniform in [0, 1) of eps_key at that counter.
//
// Builds (template arguments): kA = 8, the DQN nets' action count
// (DQNConfig.n_actions), whose row is two 16-byte loads where q starts on a
// 16-byte boundary (else eight 4-byte loads), all issued before the draws,
// and whose argmax is a tree in jnp.argmax's order (a pair's left member
// always has the lower index, which makes the tree's answer the sequential
// scan's); kA = 0 for any other A, a loop over the row in that order and
// both halves of the split.  kExplore false is the greedy launch (no keys,
// no random draws).  Threads a block: 32 to 128, as many as give every SM a
// block where the batch is small (dqn_act_shape), so that B = 512 and 1024
// spread over the SMs.
//
// Bound on this card: bytes at B = 65536 (4 * A read and 4 written an
// env: 2.36 MB, 0.70 us at 3.35 TB/s); below that the launch.  The
// integer work is three threefry blocks an env at A = 8 (the split's low
// half, the low draw, the uniform; ~80 operations each) and the argmax.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm_count.cuh"
#include "threefry.cuh"

struct DqnActParams {
  int A;                    // actions per env
  uint32_t act_k0, act_k1;  // randint's key, split on the card
  uint32_t eps_k0, eps_k1;  // key of the exploration draw
  float epsilon;            // explore where uniform < epsilon
  uint32_t env_offset;      // global index of env 0: draws at counter env_offset + b
  // set by dqn_act_launch: q starts on a 16-byte boundary (kA = 8: rows load
  // as 16-byte words); randint's multiplier (2**16 % A)**2 % A
  int vec;
  uint32_t multiplier;
};

namespace {

constexpr int kMinThreads = 32;
constexpr int kMaxThreads = 128;

// randint's multiplier (2**16 % span)**2 % span, the square wrapping in uint32.
__host__ __device__ constexpr uint32_t randint_multiplier(uint32_t span) {
  return static_cast<uint32_t>((65536u % span) * (65536u % span)) % span;
}

// jnp.argmax's order: a NaN beats everything but an earlier NaN; otherwise
// strictly greater wins, so ties keep the lower index.
__device__ __forceinline__ bool beats(float v, float best) {
  return isnan(v) ? !isnan(best) : v > best;
}

// The argmax of v[0 .. 8) in jnp.argmax's order, as a tree whose pairs
// each take their right member where it beats the left (lower) one.
__device__ __forceinline__ int argmax8(const float (&v)[8]) {
  float bv[8];
  int bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bv[i] = v[i];
    bi[i] = i;
  }
#pragma unroll
  for (int w = 1; w < 8; w <<= 1) {
#pragma unroll
    for (int i = 0; i + w < 8; i += 2 * w) {
      if (beats(bv[i + w], bv[i])) {
        bv[i] = bv[i + w];
        bi[i] = bi[i + w];
      }
    }
  }
  return bi[0];
}

// kA: the build's action count (0: p.A at run time); kExplore: the
// epsilon-greedy (else the argmax alone).
template <int kA, bool kExplore>
__global__ void __launch_bounds__(kMaxThreads) dqn_act_kernel(
    const float* __restrict__ q, int32_t* __restrict__ action, int32_t* __restrict__ random_out,
    float* __restrict__ eps_uniforms, int B, DqnActParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int out;
  if constexpr (kA == 8) {
    const float* qb = q + static_cast<long long>(b) * 8;
    float v[8];
    if (p.vec) {  // the row's two 16-byte words, both in flight
      const float4 lo = __ldg(reinterpret_cast<const float4*>(qb));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(qb) + 1);
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int a = 0; a < 8; ++a) v[a] = __ldg(qb + a);
    }
    out = argmax8(v);
  } else {
    const float* qb = q + static_cast<long long>(b) * p.A;
    float best = __ldg(qb);
    out = 0;
    for (int a = 1; a < p.A; ++a) {
      const float v = __ldg(qb + a);
      if (beats(v, best)) {
        best = v;
        out = a;
      }
    }
  }
  if constexpr (kExplore) {
    const uint32_t c = p.env_offset + static_cast<uint32_t>(b);
    int random_a;
    if constexpr (kA > 0) {  // a power of two: the multiplier is 0, the high half unused
      static_assert((kA & (kA - 1)) == 0 && randint_multiplier(kA) == 0, "kA: a power of two");
      const uint2 k_lo = tf::block(p.act_k0, p.act_k1, 0u, 1u);  // split(act_key)[1]
      random_a = static_cast<int>(tf::bits(k_lo.x, k_lo.y, 0u, c) % kA);
    } else {
      const uint2 k_hi = tf::block(p.act_k0, p.act_k1, 0u, 0u), k_lo = tf::block(p.act_k0, p.act_k1, 0u, 1u);
      const uint32_t span = static_cast<uint32_t>(p.A);
      const uint32_t hi = tf::bits(k_hi.x, k_hi.y, 0u, c), lo = tf::bits(k_lo.x, k_lo.y, 0u, c);
      random_a = static_cast<int>(((hi % span) * p.multiplier + lo % span) % span);
    }
    const float u = tf::uniform(tf::bits(p.eps_k0, p.eps_k1, 0u, c), 0.0f, 1.0f);
    if (random_out != nullptr) random_out[b] = random_a;
    if (eps_uniforms != nullptr) eps_uniforms[b] = u;
    if (u < p.epsilon) out = random_a;
  }
  action[b] = out;
}

// Threads a block for a batch of B: kMaxThreads, or where B gives the SMs
// fewer than that each, as many whole warps as give every SM a block.
int threads_for(int B) {
  const int per_sm = (B + sm_count() - 1) / sm_count();
  const int warps = (per_sm + 31) / 32;
  return warps * 32 < kMinThreads ? kMinThreads : warps * 32 > kMaxThreads ? kMaxThreads : warps * 32;
}

template <int kA, bool kExplore>
int launch(const void* q, void* action, void* random_out, void* eps_uniforms, int B,
           const DqnActParams* params, cudaStream_t stream) {
  const int threads = threads_for(B);
  dqn_act_kernel<kA, kExplore><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<int32_t*>(action), static_cast<int32_t*>(random_out),
      static_cast<float*>(eps_uniforms), B, *params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: float32[B, A] contiguous; action: int32[B]; random_out: int32[B] or null
// (the randint draws); eps_uniforms: float32[B] or null (the exploration
// uniforms), for checks.  explore: the epsilon-greedy build, else the
// argmax alone.  params->vec is set here from q's address.
extern "C" int dqn_act_launch(const void* q, void* action, void* random_out, void* eps_uniforms,
                              int B, int explore, const DqnActParams* params, void* stream) {
  DqnActParams p = *params;
  const uint32_t span = p.A > 0 ? static_cast<uint32_t>(p.A) : 1u;
  p.vec = (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
  p.multiplier = randint_multiplier(span);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.A == 8)
    return explore ? launch<8, true>(q, action, random_out, eps_uniforms, B, &p, st)
                   : launch<8, false>(q, action, random_out, eps_uniforms, B, &p, st);
  return explore ? launch<0, true>(q, action, random_out, eps_uniforms, B, &p, st)
                 : launch<0, false>(q, action, random_out, eps_uniforms, B, &p, st);
}

// The launch's shape for a batch of B and A actions: out = [threads a
// block, blocks, the build's action count (8, or 0 for the generic build)].
extern "C" int dqn_act_shape(int B, int A, int* out) {
  out[0] = threads_for(B);
  out[1] = (B + out[0] - 1) / out[0];
  out[2] = A == 8 ? 8 : 0;
  return 0;
}
