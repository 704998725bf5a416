// PPO's sampling tail inside an engine step's launch: the tail of
// tetris_gymnasium_tpu/rl/ppo.py:policy_step (:184-187) that ppo_sample.cu
// runs on its own, for the sampling builds of turbo_step.cu (kSample, L = 1
// and 8 lanes an env) and flagship_step.cu (L = 8 and 16).
//
// The launch reads the policy's logits f32[B, 8] and the step's key, draws
// JAX's Gumbel noise (threefry.cuh, counter (env_offset + b) * 8 + a),
// takes the argmax of noise + logits (the lower index on a tie) and the
// log-prob (x_a - m) - logf(sum exp(x - m)), the sum in the butterfly's
// order ((e0+e4)+(e2+e6)) + ((e1+e5)+(e3+e7)) with _rn adds, and the env
// steps with that action.  In a group of L >= 8 lanes, lane l draws action
// l & 7 and the reductions are shuffles among the 8 lanes of its eighth of
// the group (xor offsets 1, 2 and 4): with L = 16 both halves of a group
// draw the same eight actions and reach the same action, which the band's
// lane-uniform scalar logic needs.  With L = 1 one thread draws the eight
// and repeats each lane's arithmetic of the butterfly.  ppo_sample.cu, the
// stand-alone kernel, is the L = 8 group with a launch of its own.
//
// The draw (the logit's load and the threefry block) needs nothing of the
// env's state, so a kernel issues it before the state's loads and reduces
// after them.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

// The sample's arguments of a step's launch.
struct SampleArgs {
  const float* logits;  // [B, 8]
  int32_t* action;      // [B], the sampled action
  float* log_prob;      // [B], its log-prob
  uint32_t k0, k1;      // the step's key
  uint32_t env_offset;  // global index of env 0 of this batch (a rank's lo)
};

namespace sampling {

constexpr int kActions = 8;

// The sample's first half: lane `lane`'s logit x and noise + logit (L >= 8),
// or all eight (L = 1).
template <int L>
struct Draw {
  static constexpr int N = L == 1 ? kActions : 1;  // actions a thread draws
  float x[N];
  float best[N];
};

// `uniform`: null, or where to store the N uniforms behind the noise
// (ppo_sample.cu's output for checks against JAX's bits).
template <int L>
__device__ __forceinline__ void sample_draw(Draw<L>& d, const SampleArgs& s, int b, int lane,
                                            float* uniform = nullptr) {
#pragma unroll
  for (int i = 0; i < Draw<L>::N; ++i) {
    const int a = L == 1 ? i : (lane & (kActions - 1));
    // the global env's counter: (env_offset + B) * 8 < 2**31 (kernels.py)
    const uint32_t c = (s.env_offset + static_cast<uint32_t>(b)) * kActions + a;
    d.x[i] = s.logits[b * kActions + a];
    const float u = tf::gumbel_uniform(tf::bits(s.k0, s.k1, 0u, c));
    if (uniform != nullptr) uniform[i] = u;
    d.best[i] = __fadd_rn(tf::gumbel(u), d.x[i]);
  }
}

// The second half: the argmax, the max and the log-sum-exp in
// the butterfly (lanes a and a^1, a^2, a^4 for the argmax and
// the max; a^4, a^2, a^1 for the sum), the result of the eighth's lane 0.
// Every lane of a group returns the same action and the same log_prob.
template <int L>
__device__ __forceinline__ int sample_reduce(const Draw<L>& d, int lane, unsigned mask,
                                             float& log_prob) {
  if constexpr (L == 1) {
    float best[kActions], m[kActions], sum[kActions];
    int arg[kActions];
#pragma unroll
    for (int a = 0; a < kActions; ++a) {
      best[a] = d.best[a];
      arg[a] = a;
      m[a] = d.x[a];
    }
#pragma unroll
    for (int off = 1; off < kActions; off <<= 1) {
      float nb[kActions], nm[kActions];
      int na[kActions];
#pragma unroll
      for (int a = 0; a < kActions; ++a) {
        const int o = a ^ off;
        const bool take = best[o] > best[a] || (best[o] == best[a] && arg[o] < arg[a]);
        nb[a] = take ? best[o] : best[a];
        na[a] = take ? arg[o] : arg[a];
        nm[a] = fmaxf(m[a], m[o]);
      }
#pragma unroll
      for (int a = 0; a < kActions; ++a) {
        best[a] = nb[a];
        arg[a] = na[a];
        m[a] = nm[a];
      }
    }
#pragma unroll
    for (int a = 0; a < kActions; ++a) sum[a] = expf(__fsub_rn(d.x[a], m[a]));
#pragma unroll
    for (int off = kActions / 2; off >= 1; off >>= 1) {
      float ns[kActions];
#pragma unroll
      for (int a = 0; a < kActions; ++a) ns[a] = __fadd_rn(sum[a], sum[a ^ off]);
#pragma unroll
      for (int a = 0; a < kActions; ++a) sum[a] = ns[a];
    }
    float x_arg = d.x[0];
#pragma unroll
    for (int a = 1; a < kActions; ++a) x_arg = arg[0] == a ? d.x[a] : x_arg;
    log_prob = __fsub_rn(__fsub_rn(x_arg, m[0]), logf(sum[0]));
    return arg[0];
  } else {
    static_assert(L % kActions == 0, "a lane an action, in each eighth of the group");
    constexpr int W = kActions;  // the shuffles' width: an eighth of the group
    const float x = d.x[0];
    float best = d.best[0];
    int arg = lane & (W - 1);
    float m = x;
#pragma unroll
    for (int off = 1; off < kActions; off <<= 1) {
      const float ov = __shfl_xor_sync(mask, best, off, W);
      const int oa = __shfl_xor_sync(mask, arg, off, W);
      if (ov > best || (ov == best && oa < arg)) {
        best = ov;
        arg = oa;
      }
      m = fmaxf(m, __shfl_xor_sync(mask, m, off, W));
    }
    float sum = expf(__fsub_rn(x, m));
    sum = __fadd_rn(sum, __shfl_xor_sync(mask, sum, 4, W));
    sum = __fadd_rn(sum, __shfl_xor_sync(mask, sum, 2, W));
    sum = __fadd_rn(sum, __shfl_xor_sync(mask, sum, 1, W));
    arg = __shfl_sync(mask, arg, 0, W);  // lane 0's, so that the group steps one action
    const float x_arg = __shfl_sync(mask, x, arg, W);
    log_prob = __fsub_rn(__fsub_rn(x_arg, m), logf(sum));
    return arg;
  }
}

}  // namespace sampling
