// Helpers shared by every kernel of the port: staging into shared memory,
// the logistic function and the block shape of a tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Block-strided copy of n floats from device memory into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Block-strided copy of n int8 values into shared memory.
__device__ __forceinline__ void stage_q(int8_t* dst, const int8_t* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Floats of shared memory that n int8 values occupy: whole floats, so the
// carve after them stays 4-byte aligned.
__host__ __device__ inline size_t q_floats(size_t n) { return (n + 3) / 4; }

// Carves n int8 values from the float cursor p and advances it.
__device__ __forceinline__ int8_t* carve_q(float*& p, size_t n) {
  int8_t* q = reinterpret_cast<int8_t*>(p);
  p += q_floats(n);
  return q;
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
