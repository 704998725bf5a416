// Generalised advantage estimation for Hopper (sm_90a): one thread per env.
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
// as Python forms ppo.gamma * ppo.gae_lambda before JAX sees it.
//
// Layout: every [T, B] array has the env batch B as its minor axis, so the
// threads of a warp read and write consecutive words at every t.
//
// Bound on this card: bytes.  Per (t, env) it reads reward, value (4 bytes
// each) and done (1 byte) and writes advantage and target (4 bytes each),
// 17 bytes, plus 4 bytes of last_value per env: at T = 128, B = 8192 that is
// 17.9 MB, or 5.3 us at 3.35 TB/s.  With one thread per env there are only
// B threads, so the blocks are small (64 threads) to put work on every SM,
// and the loop is unrolled so that loads of later steps are in flight while
// the recursion runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) gae_kernel(
    const float* __restrict__ reward, const float* __restrict__ value,
    const uint8_t* __restrict__ done, const float* __restrict__ last_value,
    float* __restrict__ advantage, float* __restrict__ target, int T, int B, float gamma,
    float gamma_lambda) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float gae = 0.0f;
  float next_value = last_value[b];
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) {
    const long long i = static_cast<long long>(t) * B + b;
    const float r = reward[i];
    const float v = value[i];
    const float not_done = done[i] ? 0.0f : 1.0f;
    const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(__fmul_rn(gamma, next_value), not_done)), v);
    gae = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lambda, not_done), gae));
    advantage[i] = gae;
    target[i] = __fadd_rn(gae, v);
    next_value = v;
  }
}

}  // namespace

// reward, value: float32[T, B]; done: bool[T, B] (one byte, 0 or 1);
// last_value: float32[B]; advantage, target: float32[T, B] outputs.
extern "C" int gae_launch(const void* reward, const void* value, const void* done,
                          const void* last_value, void* advantage, void* target, int T, int B,
                          float gamma, float gamma_lambda, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  gae_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(reward), static_cast<const float*>(value),
      static_cast<const uint8_t*>(done), static_cast<const float*>(last_value),
      static_cast<float*>(advantage), static_cast<float*>(target), T, B, gamma, gamma_lambda);
  return static_cast<int>(cudaGetLastError());
}
