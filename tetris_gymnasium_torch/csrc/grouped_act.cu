// Masked epsilon-greedy over the grouped placements for Hopper (sm_90a):
// one thread per env, looping over its A candidates.
//
// Replaces tetris_gymnasium_tpu/rl/grouped_dqn.py:train_step (:165-174) with
// _masked_q (:72) and _masked_random (:78):
//   greedy   = argmax(where(mask > 0, q, NEG_INF))
//   random_a = argmax(where(mask > 0, gumbel(act_key, [B, A]), NEG_INF))
//   action   = where(uniform(eps_key, [B]) < epsilon, random_a, greedy)
// and, with explore off and fill = -inf, rl/evaluate.py:greedy_masked_q
// (:141).  XLA runs the noise, the two selects, the two argmaxes and the
// uniform as separate passes over [B, A]; here one pass reads q and the mask
// once and writes an int32 action.  The plain PyTorch twin is
// tetris_gymnasium_torch/rl/grouped_dqn.py:act_plain; the actions are equal.
//
// The random bits are JAX's (threefry.cuh): the Gumbel noise of (b, a) is
// threefry-2x32 of act_key at counter b * A + a, JAX's uniform in [tiny, 1)
// and -log(-log(u)); the exploration draw is the uniform in [0, 1) of eps_key
// at counter b.  The argmaxes keep the lowest index on ties and let a NaN win,
// as jnp.argmax and torch.argmax do.  The mask may be the engine's
// batch-minor [A, B] seen through a transposed view: it comes with its two
// strides, so no transposed copy is made.
//
// Bound on this card: operations.  Per env it reads 4 * A bytes of q and of
// the mask and writes 4, and runs A + 1 threefry blocks (~80 integer
// operations each) and 2 * A logf.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

struct ActParams {
  int A;                // candidates per env
  long long mask_sb;    // mask stride between envs, in elements
  long long mask_sa;    // mask stride between candidates, in elements
  float fill;           // value of an illegal candidate (NEG_INF or -inf)
  int explore;          // 0: greedy only (no random draws)
  uint32_t act_k0, act_k1;  // key of the Gumbel noise
  uint32_t eps_k0, eps_k1;  // key of the exploration draw
  float epsilon;        // explore where uniform < epsilon
};

namespace {

constexpr int kThreads = 128;

// jnp.argmax's order: a NaN beats everything but an earlier NaN; otherwise
// strictly greater wins, so ties keep the lower index.
__device__ __forceinline__ bool beats(float v, float best) {
  return isnan(v) ? !isnan(best) : v > best;
}

__global__ void __launch_bounds__(kThreads) grouped_act_kernel(
    const float* __restrict__ q, const float* __restrict__ mask, int32_t* __restrict__ action,
    float* __restrict__ noise_uniforms, float* __restrict__ eps_uniforms, int B, ActParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* qb = q + static_cast<long long>(b) * p.A;
  const float* mb = mask + b * p.mask_sb;
  float best_q = 0.0f, best_g = 0.0f;
  int arg_q = 0, arg_g = 0;
  for (int a = 0; a < p.A; ++a) {
    const bool legal = mb[a * p.mask_sa] > 0.0f;
    const float qv = legal ? qb[a] : p.fill;
    if (a == 0 || beats(qv, best_q)) {
      best_q = qv;
      arg_q = a;
    }
    if (p.explore) {
      const uint32_t c = static_cast<uint32_t>(b) * static_cast<uint32_t>(p.A) + a;
      const float u = tf::gumbel_uniform(tf::bits(p.act_k0, p.act_k1, 0u, c));
      if (noise_uniforms != nullptr) noise_uniforms[static_cast<long long>(b) * p.A + a] = u;
      const float gv = legal ? tf::gumbel(u) : p.fill;
      if (a == 0 || beats(gv, best_g)) {
        best_g = gv;
        arg_g = a;
      }
    }
  }
  int out = arg_q;
  if (p.explore) {
    const float u = tf::uniform(tf::bits(p.eps_k0, p.eps_k1, 0u, static_cast<uint32_t>(b)), 0.0f,
                                1.0f);
    if (eps_uniforms != nullptr) eps_uniforms[b] = u;
    if (u < p.epsilon) out = arg_g;
  }
  action[b] = out;
}

}  // namespace

// q: float32[B, A] contiguous; mask: float32 at mask[b * mask_sb + a * mask_sa];
// action: int32[B]; noise_uniforms: float32[B, A] or null; eps_uniforms:
// float32[B] or null (the uniforms behind the draws, for checks).
extern "C" int grouped_act_launch(const void* q, const void* mask, void* action,
                                  void* noise_uniforms, void* eps_uniforms, int B,
                                  const ActParams* params, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  grouped_act_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(mask),
      static_cast<int32_t*>(action), static_cast<float*>(noise_uniforms),
      static_cast<float*>(eps_uniforms), B, *params);
  return static_cast<int>(cudaGetLastError());
}
