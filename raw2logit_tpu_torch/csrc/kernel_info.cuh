// What a kernel occupies on the card, for the r2l_kernel_info function
// that each source exports: registers per thread, CTAs per SM at `threads`
// threads and `dyn` bytes of dynamic shared memory, and shared bytes per
// CTA (static and dynamic).

#pragma once

#include <cuda_runtime.h>

inline const char* r2l_occupancy(const void* fn, const char* name,
                                 int threads, size_t dyn, int* regs,
                                 int* ctas_per_sm, int* smem) {
  cudaFuncAttributes a;
  if ((dyn > 0 && cudaFuncSetAttribute(
                      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                      (int)dyn) != cudaSuccess) ||
      cudaFuncGetAttributes(&a, fn) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, threads,
                                                    dyn) != cudaSuccess)
    return nullptr;
  *regs = a.numRegs;
  *smem = (int)(a.sharedSizeBytes + dyn);
  return name;
}
