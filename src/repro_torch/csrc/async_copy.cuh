// Asynchronous copies from device memory into shared memory, for kernels
// whose copy width is known only at run time (B1's wide kernel, B3).
#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// One g-byte copy into shared memory: `cp.async` for 16, 8 and 4 bytes
// (16 bypasses L1), a plain load and store for 2 (visible after the next
// __syncthreads).  Both addresses are multiples of g.
__device__ __forceinline__ void unit(void* dst, const void* src, int g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (g) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
      break;
    default:
      *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most n (0..7) of this thread's newest copy groups are in flight.
__device__ __forceinline__ void wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

}  // namespace async_copy
