// Hopper's bulk-copy engine on mbarriers (sm_90a): one thread asks for a
// contiguous copy from global into shared memory, and its completion lands
// on an mbarrier in shared memory as a count of bytes. Shared by
// csrc/dma_probe.cu (K15's copy chains), csrc/leafmt_probe.cu (K14's
// per-warp ring), csrc/regroup_probe.cu (K21's staged window) and
// csrc/tpu_micro.cu (K17a's staged row, K18's copy chain, K19's ring).
//
// The protocol: an mbarrier is initialised with its arrival count and
// fenced (bar_init, then bar_init_fence) before a copy may complete on it.
// The issuer arrives with the bytes it expects (arrive_expect_tx), then
// issues the copies (bulk_copy); the phase completes once every arrival
// is in and every byte has landed. A reader waits on the phase's parity
// (bar_wait). A thread that read a buffer through the generic proxy and
// now lets the engine overwrite it issues fence.proxy.async first
// (proxy_fence): by PTX's memory model only a proxy fence orders the two.
// A consumer that only releases a buffer arrives without bytes
// (bar_arrive). Destinations and sources are 16-byte aligned, sizes a
// multiple of 16.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pt {

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar))
               : "memory");
}

// `bytes` from global `src` into shared `dst` by one bulk copy,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace pt
