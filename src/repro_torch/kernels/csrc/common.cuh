// Helpers shared by every kernel of the port: staging into shared memory,
// the logistic function and the block shape of a tile.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Block-strided copy of n floats from device memory into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Threads for a tile: one per (window, hidden unit), whole warps, at most 1024.
inline int tile_threads(int bb, int H) {
  int n = bb * H;
  n = (n + 31) / 32 * 32;
  return n < 32 ? 32 : (n > 1024 ? 1024 : n);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must ask).
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
