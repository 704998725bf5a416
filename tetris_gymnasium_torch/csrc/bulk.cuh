// Hopper's bulk asynchronous copies between global and shared memory
// (cp.async.bulk, no tensor map) and the mbarrier that a load completes on,
// shared by fn_env.cu's step and replay.cu's stacked sample.  A copy moves
// a multiple of 16 bytes between 16-byte aligned addresses; the callers'
// wrappers pick a build of word copies wherever a span or an address does
// not allow it (kernels.py), so no kernel tests it at run time.
#pragma once

#include <cstdint>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier that completes once `count` threads arrive and the
// bytes they announce have landed; then the whole block waits on it.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives on `bar` and adds `bytes` to the transactions its phase waits for.
__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` of `bar` to complete.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  uint32_t ready = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ready);
}

// global -> shared, `bytes` (a multiple of 16), completing on `bar`.
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, `bytes` (a multiple of 16), in this thread's current bulk group.
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :
               : "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// Until this thread's bulk stores have read their shared memory (before the
// block may exit and free it).
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Orders this thread's writes to shared memory before the bulk copies' reads.
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace bulk
