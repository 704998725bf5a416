// Exact grayscale for Hopper (sm_90a).
//
// Replaces tetris_gymnasium_tpu/ops/image.py:grayscale_u8_exact (:176) with
// its limb tables _gray_tables (:125): gymnasium's GrayscaleObservation,
// sum(rgb * [0.2125, 0.7154, 0.0721]) in float64 cast to uint8, evaluated
// in exact integer arithmetic.  Each product v * w_c in float64, scaled by
// 2**45, is an integer below 2**53, held as a high limb (>> 25) and a low
// limb (< 2**25); the gray value is (sum hi + (sum lo >> 25)) >> 20, all in
// int32.  The plain PyTorch twin is tetris_gymnasium_torch/ops/image.py:
// grayscale_u8_exact_plain; the output is bit-equal to it.
//
// On the TPU each channel is a 256-entry gather, which serialises there.
// Here the six tables (6 KB, built on the host in numpy float64 as the JAX
// function builds them) sit in each block's shared memory and every pixel
// does six lookups.  A thread takes four pixels: three 4-byte loads of
// their 12 RGB bytes and one 4-byte store of their grays, where the
// pointers allow, else the pixels one at a time.
//
// Bound on this card: bytes, 3 read and 1 written a pixel (67 MB over all
// 2**24 RGB triples, 20 us at 3.35 TB/s); the work is 6 lookups and 8
// integer operations a pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLimbBits = 25;
constexpr int kShift = 45 - kLimbBits;  // _FRAC_BITS - _LIMB_BITS

__device__ __forceinline__ uint32_t gray(const int32_t* hi, const int32_t* lo, uint32_t r,
                                         uint32_t g, uint32_t b) {
  const int32_t h = hi[r] + hi[256 + g] + hi[512 + b];
  const int32_t l = lo[r] + lo[256 + g] + lo[512 + b];
  return static_cast<uint32_t>((h + (l >> kLimbBits)) >> kShift) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads) gray_exact_kernel(const uint8_t* __restrict__ rgb,
                                                              uint8_t* __restrict__ out,
                                                              long long n,
                                                              const int32_t* __restrict__ tables,
                                                              int words) {
  __shared__ int32_t hi[3 * 256], lo[3 * 256];
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) {
    hi[i] = tables[i];
    lo[i] = tables[3 * 256 + i];
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = words ? n / 4 : 0;
  for (long long q = first; q < quads; q += stride) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(rgb) + 3 * q;
    const uint32_t w0 = src[0], w1 = src[1], w2 = src[2];  // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    const uint32_t p0 = gray(hi, lo, w0 & 0xFF, (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF);
    const uint32_t p1 = gray(hi, lo, w0 >> 24, w1 & 0xFF, (w1 >> 8) & 0xFF);
    const uint32_t p2 = gray(hi, lo, (w1 >> 16) & 0xFF, w1 >> 24, w2 & 0xFF);
    const uint32_t p3 = gray(hi, lo, (w2 >> 8) & 0xFF, (w2 >> 16) & 0xFF, w2 >> 24);
    reinterpret_cast<uint32_t*>(out)[q] = p0 | (p1 << 8) | (p2 << 16) | (p3 << 24);
  }
  for (long long i = 4 * quads + first; i < n; i += stride) {
    out[i] = static_cast<uint8_t>(gray(hi, lo, rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]));
  }
}

}  // namespace

// rgb: uint8[n, 3]; out: uint8[n]; tables: int32[2, 3, 256] (hi, then lo).
extern "C" int gray_exact_launch(const void* rgb, void* out, long long n, const void* tables,
                                 void* stream) {
  const int words = ((reinterpret_cast<uintptr_t>(rgb) | reinterpret_cast<uintptr_t>(out)) & 3u) == 0;
  const long long items = words ? (n / 4 + n % 4) : n;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? (want > 0 ? want : 1) : 8192);
  gray_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(out), n,
      static_cast<const int32_t*>(tables), words);
  return static_cast<int>(cudaGetLastError());
}
