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
// tetris_gymnasium_torch/rl/ppo.py:sample_actions_plain.  The arithmetic is
// sample_group.cuh's group of 8 lanes an env, which PPO's rollouts run
// inside their step's launch (the sampling builds of turbo_step.cu and
// flagship_step.cu); this launch of its own is kernels.sample_actions.
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

#include "sample_group.cuh"

namespace {

constexpr int kActions = sampling::kActions;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// sample_group.cuh's group of 8 lanes an env, the env b = t / 8 of thread t.
// Every lane runs to the end (the shuffles need full warps); the lanes past
// B draw from env B - 1's logits and store nothing (an env's 8 lanes are
// all in range or all out of it).
__global__ void __launch_bounds__(kThreads) ppo_sample_kernel(SampleArgs s,
                                                              float* __restrict__ uniform_out,
                                                              int B) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;  // B * 8 < 2**31 (kernels.py)
  const bool valid = t / kActions < static_cast<uint32_t>(B);
  const int b = valid ? static_cast<int>(t / kActions) : B - 1;
  const int lane = static_cast<int>(threadIdx.x);
  sampling::Draw<kActions> d;
  sampling::sample_draw<kActions>(d, s, b, lane,
                                  uniform_out != nullptr && valid ? uniform_out + t : nullptr);
  float log_prob;
  const int action = sampling::sample_reduce<kActions>(d, lane, kFull, log_prob);
  if (valid && (lane & (kActions - 1)) == 0) {
    s.action[b] = action;
    s.log_prob[b] = log_prob;
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
  const SampleArgs s{static_cast<const float*>(logits), static_cast<int32_t*>(action),
                     static_cast<float*>(log_prob), k0, k1, static_cast<uint32_t>(env_offset)};
  ppo_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<float*>(uniform_out), B);
  return static_cast<int>(cudaGetLastError());
}
