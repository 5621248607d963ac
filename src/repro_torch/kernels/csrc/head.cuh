// Pieces of the dense head (RMS-norm -> optional Qm.n activation step ->
// ReLU MLP) that warp_cell.cuh's warp_head reads: the Qm.n step and the RMS
// epsilon.
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

}  // namespace repro
