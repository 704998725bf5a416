// The DQN's epsilon-greedy over a Q-net's action values for Hopper (sm_90a):
// one thread per env.
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
// (the host passes both halves), draws 32 bits hi and lo of each half at
// counter env_offset + b (the global env index; env_offset is a rank's first
// env, 0 on one device), and returns ((hi % A) * m + lo % A) % A in wrapping uint32
// arithmetic, m = (2**16 % A)**2 % A (0 for A = 8); the exploration draw is
// JAX's uniform in [0, 1) of eps_key at that counter.  The argmax keeps the
// lowest index on ties and lets a NaN win, as jnp.argmax and torch.argmax do.
//
// Bound on this card: operations, ~250 32-bit operations an env (three
// threefry blocks, the argmax and the select) against 4 * A bytes read and 4
// written; at B = 1024 either bound is ~0.01 us, so a launch costs more.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

struct DqnActParams {
  int A;                    // actions per env
  int explore;              // 0: greedy only (no random draws)
  uint32_t hi_k0, hi_k1;    // first half of act_key's split (randint's high bits)
  uint32_t lo_k0, lo_k1;    // second half (low bits)
  uint32_t multiplier;      // (2**16 % A)**2 % A, the square wrapping in uint32
  uint32_t eps_k0, eps_k1;  // key of the exploration draw
  float epsilon;            // explore where uniform < epsilon
  uint32_t env_offset;      // global index of env 0: draws at counter env_offset + b
};

namespace {

constexpr int kThreads = 128;

// jnp.argmax's order: a NaN beats everything but an earlier NaN; otherwise
// strictly greater wins, so ties keep the lower index.
__device__ __forceinline__ bool beats(float v, float best) {
  return isnan(v) ? !isnan(best) : v > best;
}

__global__ void __launch_bounds__(kThreads) dqn_act_kernel(
    const float* __restrict__ q, int32_t* __restrict__ action, int32_t* __restrict__ random_out,
    float* __restrict__ eps_uniforms, int B, DqnActParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* qb = q + static_cast<long long>(b) * p.A;
  float best = qb[0];
  int arg = 0;
  for (int a = 1; a < p.A; ++a) {
    const float v = qb[a];
    if (beats(v, best)) {
      best = v;
      arg = a;
    }
  }
  int out = arg;
  if (p.explore) {
    const uint32_t c = p.env_offset + static_cast<uint32_t>(b);
    const uint32_t span = static_cast<uint32_t>(p.A);
    const uint32_t hi = tf::bits(p.hi_k0, p.hi_k1, 0u, c);
    const uint32_t lo = tf::bits(p.lo_k0, p.lo_k1, 0u, c);
    const int random_a = static_cast<int>(((hi % span) * p.multiplier + lo % span) % span);
    const float u = tf::uniform(tf::bits(p.eps_k0, p.eps_k1, 0u, c), 0.0f, 1.0f);
    if (random_out != nullptr) random_out[b] = random_a;
    if (eps_uniforms != nullptr) eps_uniforms[b] = u;
    if (u < p.epsilon) out = random_a;
  }
  action[b] = out;
}

}  // namespace

// q: float32[B, A] contiguous; action: int32[B]; random_out: int32[B] or null
// (the randint draws); eps_uniforms: float32[B] or null (the exploration
// uniforms), for checks.
extern "C" int dqn_act_launch(const void* q, void* action, void* random_out, void* eps_uniforms,
                              int B, const DqnActParams* params, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  dqn_act_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<int32_t*>(action),
      static_cast<int32_t*>(random_out), static_cast<float*>(eps_uniforms), B, *params);
  return static_cast<int>(cudaGetLastError());
}
