// Pieces of the dense head (RMS-norm -> optional Qm.n activation step ->
// ReLU MLP) shared by the kernels' heads: the Qm.n step and the RMS epsilon
// (warp_cell.cuh warp_head, the fp32 fused kernels' and the tick's head) and
// the block-per-tile RMS-norm (head_q.cuh, the int8 serving kernels' head).
//
// Counterpart of repro/kernels/mr_step/kernel.py:64-76 (_head_math) and the
// CUDA twin of repro_torch/core/merinda.py head_math.
//
// QAT is a training-time switch, so the activation step arrives as two ints,
// (act_int, act_frac), with act_frac < 0 meaning none, not as a template.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kRmsEps = 1e-6f;  // core/merinda.py RMS_EPS

// quantize_fixed: clip(rint(x * 2^f), -2^(i+f-1), 2^(i+f-1) - 1) / 2^f.
// rintf rounds half to even, as jnp.round and torch.round do.
__device__ __forceinline__ float quantize_fixed(float x, int int_bits, int frac_bits) {
  const float scale = ldexpf(1.0f, frac_bits);
  const float top = ldexpf(1.0f, int_bits + frac_bits - 1);
  return fminf(fmaxf(rintf(x * scale), -top), top - 1.0f) / scale;
}

// hn[w] = q(h[w] * rsqrt(mean(h[w]^2) + eps)) for the tile's bb windows, one
// warp a window with a shuffle reduction over H; q is the optional Qm.n step
// (act_frac < 0: none). h and hn are [bb, H] in shared memory; hn may be h
// itself, since each lane rewrites only the units it read after the warp's
// reduction. The caller publishes hn with a barrier.
__device__ inline void rms_norm_tile(const float* h, float* hn, int H, int bb, int act_int,
                                     int act_frac) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int w = warp; w < bb; w += n_warps) {
    const float* hw = h + w * H;
    float acc = 0.0f;
    for (int k = lane; k < H; k += 32) acc = fmaf(hw[k], hw[k], acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float inv = rsqrtf(acc / H + kRmsEps);
    for (int k = lane; k < H; k += 32) {
      const float v = hw[k] * inv;
      hn[w * H + k] = act_frac >= 0 ? quantize_fixed(v, act_int, act_frac) : v;
    }
  }
}

}  // namespace repro
