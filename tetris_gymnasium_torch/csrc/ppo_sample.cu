// PPO's sampling tail for Hopper (sm_90a): categorical sample and log-prob,
// eight threads per env, one thread per (env, action).
//
// Replaces the tail of tetris_gymnasium_tpu/rl/ppo.py:policy_step
// (:184-187):
//   action   = jax.random.categorical(act_key, logits)   (Gumbel-max)
//   log_prob = jax.nn.log_softmax(logits)[b, action]
// where XLA runs the noise, the argmax, the log-softmax and the gather as
// separate passes over [B, 8].  Here one pass reads the logits once and
// writes the action and its log-prob.  The plain PyTorch twin is
// tetris_gymnasium_torch/rl/ppo.py:sample_actions_plain.
//
// The noise is JAX's, bit for bit: element (b, a) takes threefry-2x32 of
// the step's key at counter [0, (env_offset + b)*8 + a]
// (jax_threefry_partitionable; env_offset is the global index of the batch's
// env 0, a rank's first env, 0 on one device),
// bits = y0 ^ y1, JAX's float32 uniform in [tiny, 1), and -log(-log(u))
// (threefry.cuh).  The argmax keeps the lowest index on ties, as jnp.argmax.  The
// log-softmax is (x - max) - log(sum exp(x - max)) with the sum taken as the
// butterfly over the 8 lanes gives it, ((e0+e4)+(e2+e6)) + ((e1+e5)+(e3+e7)),
// and the plain version adds in that order too.  Every add and multiply is
// an _rn intrinsic, so none is contracted into an FMA; logf and expf are the
// CUDA library functions that PyTorch's log and exp call.
//
// Bound on this card: operations, barely.  Per env it reads 8 float32
// logits and writes an int32 and a float32, 40 bytes; it also runs 8
// threefry blocks (about 80 integer operations each) and 17 logf/expf.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kActions = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) ppo_sample_kernel(
    const float* __restrict__ logits, int32_t* __restrict__ action, float* __restrict__ log_prob,
    float* __restrict__ uniform_out, long long n, long long base, uint32_t k0, uint32_t k1) {
  // Every lane runs to the end (the shuffles need full warps); lanes past n
  // compute on a zero logit and store nothing.  n = B * 8, so an env's 8
  // lanes are all in range or all out of it.
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = t < n;
  const int a = static_cast<int>(threadIdx.x) & (kActions - 1);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const float x = valid ? logits[t] : 0.0f;

  const long long c = base + t;  // the global counter, env_offset * 8 + t
  const float u = tf::gumbel_uniform(
      tf::bits(k0, k1, static_cast<uint32_t>(c >> 32), static_cast<uint32_t>(c)));
  const float g = tf::gumbel(u);
  if (uniform_out != nullptr && valid) uniform_out[t] = u;  // for checks against JAX's bits

  // argmax of g + x over the env's 8 lanes, the lower index winning a tie
  float best = __fadd_rn(g, x);
  int arg = a;
  float m = x;
#pragma unroll
  for (int off = 1; off < kActions; off <<= 1) {
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, arg, off);
    if (ov > best || (ov == best && oa < arg)) {
      best = ov;
      arg = oa;
    }
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  }

  // log-sum-exp, the butterfly's order: lanes a and a^4, then a^2, then a^1
  float s = expf(__fsub_rn(x, m));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 4));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
  const float x_arg = __shfl_sync(kFull, x, (lane & ~(kActions - 1)) | arg);

  if (valid && a == 0) {
    const long long b = t / kActions;
    action[b] = arg;
    log_prob[b] = __fsub_rn(__fsub_rn(x_arg, m), logf(s));
  }
}

}  // namespace

// logits: float32[B, 8]; action: int32[B] and log_prob: float32[B] outputs;
// uniform_out: float32[B, 8] or null, the uniforms behind the noise;
// (k0, k1): the step's key; env_offset: the global index of env 0.
extern "C" int ppo_sample_launch(const void* logits, void* action, void* log_prob,
                                 void* uniform_out, int B, uint32_t k0, uint32_t k1,
                                 int env_offset, void* stream) {
  const long long n = static_cast<long long>(B) * kActions;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  ppo_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int32_t*>(action),
      static_cast<float*>(log_prob), static_cast<float*>(uniform_out), n,
      static_cast<long long>(env_offset) * kActions, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
