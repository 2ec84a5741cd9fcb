// Dynamic shared memory above 48 KB, and what a launch gets of an SM.
// Above 48 KB a kernel gets dynamic shared memory only after opting in on
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

// What a launch of `kernel` with `threads` threads and `dynamic_bytes` of
// dynamic shared memory gets on the current device, into out[0..4]:
// registers a thread, static shared bytes, threads a CTA, CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), dynamic shared bytes.
// Returns 0 or the CUDA error.
template <typename Kernel>
inline int kernel_occupancy(Kernel kernel, int threads, size_t dynamic_bytes,
                            int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int refused = allow_dynamic_shared(kernel, dynamic_bytes);
  if (refused != 0) return refused;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      dynamic_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = threads;
  out[3] = ctas;
  out[4] = static_cast<int>(dynamic_bytes);
  return 0;
}
