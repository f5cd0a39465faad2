// Bulk copies from global to shared memory through the copy engine
// (cp.async.bulk, sm_90), completed on a shared-memory mbarrier, shared by
// the port's kernels that stage rows of a tile this way (mla_attention.cu,
// rwkv6_scan.cu).
//
// One thread copies a whole row (16-byte aligned, a multiple of 16 bytes)
// with one instruction, and the bytes arrive without the per-thread
// 16-byte requests of cp.async.  A ring slot has a "full" barrier (one
// arrival): one thread announces the slot's bytes with expect, every copy
// into the slot counts its bytes down, and the consumers wait on the
// barrier's phase parity (the n-th fill of a slot is phase n, parity
// n & 1).  Copies may complete before the announcement: the barrier's
// transaction count may run negative until it arrives.  A slot is refilled
// only after a __syncthreads() that follows every read of it.
#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Once, by one thread, before any use; then a __syncthreads().  A phase
// completes at its one arrival (expect) and its announced bytes.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The slot's arrival: `bytes` will be copied into it in this phase.
__device__ __forceinline__ void expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` from global src to shared dst, counted down on bar.  The fence
// orders this thread's view of earlier generic-proxy accesses to shared
// memory (made visible to it by a barrier) before the copy's writes.
__device__ __forceinline__ void copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace bulk
