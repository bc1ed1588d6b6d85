// What the lane-filter walk (lane_filter.cu) and NMS (nms.cu) kernels share
// to hand data between the blocks of a thread-block cluster: a block stores
// 4-byte words into another block's shared memory with st.async, each store
// completing 4 bytes of the receiving block's mbarrier transaction, and the
// receiver waits for the bytes it expects. Plus %globaltimer, which their
// stage stamps read.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace avp {

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// a 4-byte store into a block's shared memory (addr, from in_rank) that
// completes 4 bytes of that block's mbarrier `bar` (from in_rank too)
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// One arrival expected, made at once with `bytes` of transaction to come.
// Before another block stores to it: fence.mbarrier_init.release.cluster,
// then a cluster barrier.
__device__ __forceinline__ void mbar_init_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar)
      : "memory");
  return done != 0;
}

// Waits for phase 0; a wait of more than 10 s traps, so a fault ends the
// launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  if (mbar_try_wait(bar)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

}  // namespace avp
