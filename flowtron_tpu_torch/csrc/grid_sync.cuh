// Grid-wide and copy synchronisation shared by the persistent
// cooperative kernels (csrc/decoder.cu, csrc/resident.cu,
// csrc/fused_cost.cu): a grid barrier on a counter in global memory, the
// mbarrier that bulk (TMA) copies into shared memory complete on, and the
// card's nanosecond clock.

#pragma once

#include <stdint.h>

#include "mma.cuh"

namespace {

// The grid barrier, in two halves so that a block can start work that
// no other block waits for in between: every block adds one to *bar
// (release) once all its threads are done, then one thread spins until
// the counter reaches target = barriers passed x grid (acquire). The
// counter only grows, so it needs no reset between barriers.
__device__ __forceinline__ void barrier_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
                 :: "l"(bar), "r"(1u) : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// The prefetch buffer's mbarrier: one arrival (with the bytes to expect)
// and the bulk copies' completions end each phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The one arrival of a phase, announcing the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory, completing on *bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The card's nanosecond clock (the kernels' stage clocks).
__device__ __forceinline__ long long gtime() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

}  // namespace
