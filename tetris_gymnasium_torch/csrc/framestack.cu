// The frame-stack push for Hopper (sm_90a): roll the newest observation into
// each env's K-frame window, or restart the window where the env's episode
// just ended.
//
// Replaces tetris_gymnasium_tpu/ops/framestack.py:push (:37), which the DQN
// (rl/dqn.py:171), the PPO rollout (rl/ppo.py:186) and the evaluation
// (rl/evaluate.py:87) call once a step:
//   out[b] = done[b] ? repeat(obs[b], K) : concat(stack[b, 1:], obs[b])
// The window is [B, K, H, W] int8, oldest frame first.  The plain PyTorch
// twin is tetris_gymnasium_torch/ops/framestack.py:push_plain; the output is
// bit-equal to it.
//
// One thread per output word: word w of frame j of env b comes from the new
// observation when done[b] or j == K - 1, else from frame j + 1 of the old
// window.  The words are 16, 4 or 1 bytes, the widest that the frame size
// and the pointers allow (a 20x10 frame is 200 bytes: 4-byte words).
//
// Bound on this card: bytes.  It reads the K - 1 kept frames of each env
// whose done flag is clear (none where it is set), the new frame and the done
// flag, and writes K frames; at B = 1024, K = 4 that is at most 1.64 MB in
// and out, ~0.49 us at 3.35 TB/s, so at the DQN's shape a launch costs more
// than the copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) framestack_push_kernel(
    const T* __restrict__ stack, const T* __restrict__ obs, const bool* __restrict__ done,
    T* __restrict__ out, long long n_words, int k, long long frame_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_words;
       i += stride) {
    const long long w = i % frame_words;
    const long long bj = i / frame_words;  // b * k + j
    const int j = static_cast<int>(bj % k);
    const long long b = bj / k;
    out[i] = (done[b] || j == k - 1) ? obs[b * frame_words + w] : stack[i + frame_words];
  }
}

template <typename T>
void launch(const void* stack, const void* obs, const void* done, void* out, int B, int k,
            long long frame_bytes, cudaStream_t stream) {
  const long long frame_words = frame_bytes / static_cast<long long>(sizeof(T));
  const long long n_words = static_cast<long long>(B) * k * frame_words;
  long long blocks = (n_words + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > 8192 ? 8192 : blocks);
  framestack_push_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(stack), static_cast<const T*>(obs), static_cast<const bool*>(done),
      static_cast<T*>(out), n_words, k, frame_words);
}

}  // namespace

// stack: int8[B, k, H, W]; obs: int8[B, H, W]; done: bool[B]; out: int8[B, k,
// H, W]; all contiguous.  frame_bytes = H * W; word: 16, 4 or 1, dividing
// frame_bytes and every pointer.
extern "C" int framestack_push_launch(const void* stack, const void* obs, const void* done,
                                      void* out, int B, int k, long long frame_bytes, int word,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word == 16) launch<uint4>(stack, obs, done, out, B, k, frame_bytes, s);
  else if (word == 4) launch<uint32_t>(stack, obs, done, out, B, k, frame_bytes, s);
  else launch<uint8_t>(stack, obs, done, out, B, k, frame_bytes, s);
  return static_cast<int>(cudaGetLastError());
}
