// Hand-offs between the warps of one block, for the warp-specialised
// kernels (a chain warp and the warps that feed it).
//
//  * Named barriers (bar.sync / bar.arrive, ids 1..15; 0 is
//    __syncthreads): n threads, a multiple of 32, meet at barrier `id`;
//    a warp that only signals arrives and goes on.  Both order the
//    memory accesses of the threads that meet, shared and global.  They
//    are the aligned forms, which a warp must reach converged, so each
//    first reconverges the warp with __syncwarp: the producer warps
//    reach their barriers after data-dependent loops.
//  * Flags in shared memory: one thread publishes a value with a
//    release store after the data it guards, another spins on an
//    acquire load until it reads that value, and then sees the data.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void bar_sync(int id, int n) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void flag_release(int* flag, int value) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(flag));
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(a), "r"(value)
               : "memory");
}
__device__ __forceinline__ void flag_wait(const int* flag, int value) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(flag));
  int seen;
  do {
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
                 : "=r"(seen)
                 : "r"(a)
                 : "memory");
  } while (seen != value);
}

}  // namespace
