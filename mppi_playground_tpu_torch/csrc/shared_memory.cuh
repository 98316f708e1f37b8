// A kernel's dynamic shared memory past its default limit.
//
// By default a launch may take 48 KB of shared memory, its kernel's static
// share included; more is refused unless the kernel is given a larger limit
// first (up to 227 KB a block on Hopper).  Every launcher whose dynamic share
// depends on the launch's sizes calls allow_shared before its launch.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace fused {

// Set `kernel`'s limit of dynamic shared memory to `bytes` (none asked: no
// call).  The limit holds whatever the kernel's static share is, so no launch
// needs to know it; a size the card cannot give returns the error here.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fused
