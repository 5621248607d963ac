// Helpers shared by every kernel of the port: the logistic function, the
// carve of int8 values in whole floats and the dynamic shared-memory limit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Floats of shared memory that n int8 values occupy: whole floats, so the
// carve after them stays 4-byte aligned.
__host__ __device__ inline size_t q_floats(size_t n) { return (n + 3) / 4; }

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it must ask).
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
