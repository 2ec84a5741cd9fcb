// Dynamic shared memory above 48 KB: a kernel gets it only after opting in on
// the current device, and then at most the card's 227 KB less the kernel's
// static shared memory. The limit lives in one place, ops/_build.py
// SHARED_OPT_IN_BYTES, which the wrappers check before they launch.
#pragma once

#include <cuda_runtime.h>

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// Launches that need more than 48 KB set the attribute every time (a cheap
// host call), so that no cached state can be stale on another device. A
// refusal is cleared from the error state, so that the next launch's check
// does not report it, and returned.
template <typename Kernel>
inline int allow_dynamic_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return 0;
}
