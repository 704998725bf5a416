// Masked epsilon-greedy over the grouped placements for Hopper (sm_90a):
// a group of L lanes an env (L = 8, 16 or 32), the candidates split across
// its lanes.
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
// at counter b.
//
// Bound on this card: operations.  Per env it reads 4 * A bytes of q and of
// the mask and writes 4, and runs A + 1 threefry blocks (~80 integer
// operations each) and 2 * A logf.  With one thread an env the time would
// be the chain of one thread's A + 1 dependent threefry blocks (flat from
// 1024 to 4096 envs on an H100, 200x the bound).  Here lane l of an env's
// group takes candidates l, l + L, ... in order, keeping a running best
// (value, index) for the greedy and for the Gumbel argmax, and the last lane
// draws the exploration uniform beside its candidates, so the chain is
// ceil(A / L) blocks.  A butterfly of log2(L) shuffles then combines the
// lanes' pairs in jnp.argmax's order (`wins`): a NaN beats everything but a
// NaN of a lower index; otherwise the greater value wins, and equal values
// (+0.0 and -0.0 among them) keep the lower index, across lanes too.  A lane
// without candidates holds (-inf, A), which every candidate beats or ties
// with a lower index, so a row with every candidate illegal gives index 0.
//
// The mask comes with any strides: the grouped DQN passes the engine's
// [A, B] mask transposed (stride B across candidates), so the lanes read it
// 4 bytes a 32-byte sector, from the L2 where the engine's launch just
// wrote it.  A build that first staged the block's mask tile through
// shared memory (threads over envs, coalesced) was slower at every batch
// and lane width on an H100 (PERF.md) and went.

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

// jnp.argmax's order for (v, i) against (w, j): a NaN wins unless w is a
// NaN of a lower index; otherwise the greater value, and on equal values
// the lower index.
__device__ __forceinline__ bool wins(float v, int i, float w, int j) {
  if (isnan(v)) return !isnan(w) || i < j;
  if (isnan(w)) return false;
  return v > w || (v == w && i < j);
}

template <int L>
__device__ __forceinline__ void combine(float& v, int& i) {
#pragma unroll
  for (int off = L / 2; off >= 1; off /= 2) {
    const float w = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    const int j = __shfl_xor_sync(0xFFFFFFFFu, i, off);
    if (wins(w, j, v, i)) {
      v = w;
      i = j;
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads) grouped_act_kernel(
    const float* __restrict__ q, const float* __restrict__ mask, int32_t* __restrict__ action,
    float* __restrict__ noise_uniforms, float* __restrict__ eps_uniforms, int B, ActParams p) {
  constexpr int kEnvs = kThreads / L;
  const int lane = threadIdx.x % L, e = threadIdx.x / L;
  const int b = blockIdx.x * kEnvs + e;
  const int A = p.A;
  // every lane of the warp runs the shuffles; lanes past B hold sentinels
  float best_q = -INFINITY, best_g = -INFINITY;
  int arg_q = A, arg_g = A;
  float eps_u = 0.0f;
  if (b < B) {
    const float* qb = q + static_cast<long long>(b) * A;
    for (int a = lane; a < A; a += L) {
      const bool legal = mask[b * p.mask_sb + a * p.mask_sa] > 0.0f;
      const float qv = legal ? qb[a] : p.fill;
      if (a == lane || wins(qv, a, best_q, arg_q)) {
        best_q = qv;
        arg_q = a;
      }
      if (p.explore) {
        const uint32_t c = static_cast<uint32_t>(b) * static_cast<uint32_t>(A) + a;
        const float u = tf::gumbel_uniform(tf::bits(p.act_k0, p.act_k1, 0u, c));
        if (noise_uniforms != nullptr) noise_uniforms[static_cast<long long>(b) * A + a] = u;
        const float gv = legal ? tf::gumbel(u) : p.fill;
        if (a == lane || wins(gv, a, best_g, arg_g)) {
          best_g = gv;
          arg_g = a;
        }
      }
    }
    if (p.explore && lane == L - 1)
      eps_u = tf::uniform(tf::bits(p.eps_k0, p.eps_k1, 0u, static_cast<uint32_t>(b)), 0.0f, 1.0f);
  }
  combine<L>(best_q, arg_q);
  if (p.explore) combine<L>(best_g, arg_g);
  if (b < B && lane == L - 1) {
    int out = arg_q;
    if (p.explore) {
      if (eps_uniforms != nullptr) eps_uniforms[b] = eps_u;
      if (eps_u < p.epsilon) out = arg_g;
    }
    action[b] = out == A ? 0 : out;
  }
}

template <int L>
int launch(const float* q, const float* mask, int32_t* action, float* noise_u, float* eps_u, int B,
           const ActParams& p, cudaStream_t stream) {
  constexpr int kEnvs = kThreads / L;
  grouped_act_kernel<L><<<(B + kEnvs - 1) / kEnvs, kThreads, 0, stream>>>(q, mask, action, noise_u, eps_u,
                                                                          B, p);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int occupancy() {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grouped_act_kernel<L>, kThreads, 0);
  return rc == cudaSuccess ? blocks : -static_cast<int>(rc);
}

}  // namespace

// q: float32[B, A] contiguous; mask: float32 at mask[b * mask_sb + a * mask_sa];
// action: int32[B]; noise_uniforms: float32[B, A] or null; eps_uniforms:
// float32[B] or null (the uniforms behind the draws, for checks); lanes: 8,
// 16 or 32 an env.
extern "C" int grouped_act_launch(const void* q, const void* mask, void* action,
                                  void* noise_uniforms, void* eps_uniforms, int B,
                                  const ActParams* params, int lanes, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* mf = static_cast<const float*>(mask);
  auto* act = static_cast<int32_t*>(action);
  auto* nu = static_cast<float*>(noise_uniforms);
  auto* eu = static_cast<float*>(eps_uniforms);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 8: return launch<8>(qf, mf, act, nu, eu, B, *params, s);
    case 16: return launch<16>(qf, mf, act, nu, eu, B, *params, s);
    case 32: return launch<32>(qf, mf, act, nu, eu, B, *params, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks an SM holds of each build: out[0..2] = lanes 8, 16, 32.
extern "C" int grouped_act_occupancy(int* out) {
  out[0] = occupancy<8>();
  out[1] = occupancy<16>();
  out[2] = occupancy<32>();
  return static_cast<int>(cudaGetLastError());
}
